"""The port's train, eval and predict steps against the JAX package's.

Weights are drawn by the port at 16^3, width 0.25 (BN affine and statistics
randomised), converted to the JAX package's trees by its own
``convert_torch_state_dict``, and each side builds its train state from
them; the batch is seeded numpy with painted cubes, as in
``tests/test_train.py``. float32:

* one train step: total / conf / loc loss and grad_norm within 1e-5
  relative; every gradient leaf (``return_grads``) within 1e-4 of the
  leaf's norm; BN statistics within 1e-5; params and EMA within 1e-5 on at
  least 99.9% of elements and within 4 lr on all (Adam's first step moves
  an element by about lr whatever its gradient's size, so a near-zero
  gradient whose sign differs between the two frameworks moves it 2 lr the
  other way, 4 lr in the bias group);
* three steps: the losses within 1e-4 relative; ``grad_accum=2``; the
  non-finite skip (params, BN statistics and the optimizer's count kept,
  ``step`` and the streak advanced);
* the eval, predict and gathered steps, ``with_detections``.

Batches are 8 volumes: at 4 the deepest BNs normalise 4 values a channel
and both frameworks' float32 gradients sit up to ~1e-3 of a leaf's norm from
float64 (ROADMAP §3). bfloat16, at 32^3: the loss within 2e-2 relative and
the whole gradient vector within 5e-2 relative (Frobenius).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.models import model_priors as jax_model_priors
from mslesions3d_tpu.train import steps as jax_steps
from mslesions3d_tpu.train.state import TrainState as JaxTrainState
from mslesions3d_tpu.train.state import make_optimizer as jax_make_optimizer
from mslesions3d_tpu.train.torch_import import convert_torch_state_dict
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_gathered_eval_step,
    make_gathered_train_step,
    make_predict_step,
    make_train_step,
)
from mslesions3d_tpu_torch.weights import from_jax_batch_stats, from_jax_params

# torch's first CPU log of a process can come back off by up to ~1e3 float32
# ulp in one thread's block (ROADMAP.md §3, tests/probe_torch_first_log.py);
# one small single-threaded call first avoids it
torch.log(torch.ones(8))

LR = 1e-3
KW = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=LR,
          threshold=(0.1, 0.2), ema_decay=0.5, min_score=0.3)


def _source_state_dict(config, seed=0):
    """Port init with the BN affine and running statistics randomised."""
    state = SSD3D(config, generator=torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed)
    for key in list(state):
        if key.endswith("running_mean"):
            prefix, c = key[: -len("running_mean")], state[key].shape[0]
            for name, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.2, 0.2),
                                 ("running_mean", -0.3, 0.3), ("running_var", 0.5, 2.0)):
                state[prefix + name] = torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32))
    return {k: v.float() if v.is_floating_point() else v for k, v in state.items()}


def _jax_state(config, source):
    params, stats = convert_torch_state_dict({k: v.numpy() for k, v in source.items()}, config)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    stats = jax.tree_util.tree_map(jnp.asarray, stats)
    tx, _ = jax_make_optimizer(config.lr, config.scheduler, t_max=config.t_max)
    return JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params), nonfinite_streak=jnp.asarray(0, jnp.int32),
        ema_params=jax.tree_util.tree_map(jnp.copy, params) if config.ema_decay > 0 else None,
        tx=tx)


def _batch(batch=8, seed=0, d=16):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (batch, d, d, d, 1)).astype(np.float32)
    boxes = np.zeros((batch, 3, 6), np.float32)
    labels = np.zeros((batch, 3), np.int32)
    mask = np.zeros((batch, 3), bool)
    for b in range(batch):
        for j in range(2):
            lo = rng.uniform(0.05, 0.5, 3)
            boxes[b, j] = np.concatenate([lo, lo + rng.uniform(0.25, 0.45, 3)]).clip(0, 1)
            labels[b, j], mask[b, j] = 1, True
            vox = (boxes[b, j] * d).astype(int)
            images[b, vox[0]:vox[3], vox[1]:vox[4], vox[2]:vox[5], 0] += 3.0
    return {"image": images, "boxes": boxes, "labels": labels, "box_mask": mask,
            "batch_mask": np.ones(batch, bool)}


class Pair:
    """A JAX and a port setup on the same weights."""

    def __init__(self, dtype="float32", **extra):
        kw = dict(KW, dtype=dtype, **extra)
        self.jcfg, self.cfg = JaxConfig.create(**kw), SSD3DConfig.create(**kw)
        self.priors = model_priors(self.cfg)
        np.testing.assert_array_equal(self.priors, jax_model_priors(self.jcfg))
        source = _source_state_dict(SSD3DConfig.create(**dict(kw, dtype="float32")))
        self.jmodel = JaxSSD3D(self.jcfg)
        self.jstate = _jax_state(self.jcfg, source)
        self.model = SSD3D(self.cfg)
        self.state = create_train_state(self.cfg, device="cpu", state_dict=source)


@pytest.fixture(scope="module")
def f32():
    pair = Pair()
    pair.jstep = jax_steps.make_train_step(pair.jcfg, pair.jmodel, pair.priors, donate=False,
                                           return_grads=True, with_detections=True)
    pair.step = make_train_step(pair.cfg, pair.model, pair.priors, return_grads=True,
                                with_detections=True)
    pair.batch = _batch()
    return pair


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close_rel(a, b, rtol):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol)


def assert_params_close(ours: dict, ref: dict, bias_lr=2 * LR):
    diffs = np.concatenate([np.abs(_np(ours[k]) - _np(ref[k])).ravel() for k in ref])
    assert (diffs <= 1e-5).mean() >= 0.999, (diffs > 1e-5).mean()
    assert diffs.max() <= 2 * bias_lr


def _jax_counts(opt_state):
    return {int(opt_state.inner_states[g].inner_state[1].count) for g in ("bias", "weight")}


def test_one_train_step_matches_jax(f32):
    jnew, jm = f32.jstep(f32.jstate, f32.batch, jax.random.PRNGKey(0))
    new, m = f32.step(f32.state, f32.batch)
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm"):
        _close_rel(m[key], jm[key], 1e-5)
    assert float(m["n_positives"]) == float(jm["n_positives"]) == 16.0
    assert float(m["nonfinite"]) == 0.0 and int(new.nonfinite_streak) == 0
    ref_grads = from_jax_params(jax.device_get(jm["grads"]), f32.cfg)
    assert ref_grads.keys() == m["grads"].keys() == f32.state.params.keys()
    for name, ref in ref_grads.items():
        norm = float(np.linalg.norm(_np(ref)))
        np.testing.assert_allclose(_np(m["grads"][name]), _np(ref), rtol=0,
                                   atol=1e-4 * max(norm, 1e-12), err_msg=name)
    assert not m["grads"]["rescale_factors"].any()  # unused while use_l2_rescale is off
    ref_stats = from_jax_batch_stats(jnew.params, jax.device_get(jnew.batch_stats))
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(_np(new.batch_stats[name]), _np(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        assert not torch.equal(new.batch_stats[name], f32.state.batch_stats[name])
    assert_params_close(new.params, from_jax_params(jax.device_get(jnew.params), f32.cfg))
    assert_params_close(new.ema_params, from_jax_params(jax.device_get(jnew.ema_params), f32.cfg))
    assert int(new.step) == int(new.opt_state.count) == 1 and _jax_counts(jnew.opt_state) == {1}
    # rescale_factors moved under L2 decay alone
    assert not torch.equal(new.params["rescale_factors"], f32.state.params["rescale_factors"])
    # the old state is left as it was
    assert int(f32.state.step) == 0
    # with_detections: the training forward's detections and the GT it saw
    det, jdet = m["detections"], jm["detections"]
    np.testing.assert_array_equal(det["count"].numpy(), np.asarray(jdet["count"]))
    np.testing.assert_allclose(det["scores"].numpy(), np.asarray(jdet["scores"]), atol=1e-5)
    np.testing.assert_allclose(det["boxes"].numpy(), np.asarray(jdet["boxes"]), atol=1e-5)
    assert int(det["count"].sum()) > 0
    np.testing.assert_array_equal(m["aug_box_mask"].numpy(), np.asarray(jm["aug_box_mask"]))


def test_three_train_steps_match_jax(f32):
    jstate, state = f32.jstate, f32.state
    losses, ref = [], []
    for i in range(3):
        batch = _batch(seed=i)
        jstate, jm = f32.jstep(jstate, batch, jax.random.PRNGKey(i))
        state, m = f32.step(state, batch)
        losses.append(float(m["total_loss"]))
        ref.append(float(jm["total_loss"]))
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    assert int(state.step) == 3 and int(state.opt_state.count) == 3


def test_grad_accum_matches_jax():
    pair = Pair()
    jstep = jax_steps.make_train_step(pair.jcfg, pair.jmodel, pair.priors, donate=False,
                                      grad_accum=2)
    step = make_train_step(pair.cfg, pair.model, pair.priors, grad_accum=2)
    batch = _batch(batch=16, seed=5)
    jnew, jm = jstep(pair.jstate, batch, jax.random.PRNGKey(0))
    new, m = step(pair.state, batch)
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm"):
        _close_rel(m[key], jm[key], 1e-5)
    # the BN statistics chained micro-batch to micro-batch
    ref_stats = from_jax_batch_stats(jnew.params, jax.device_get(jnew.batch_stats))
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(_np(new.batch_stats[name]), _np(ref), rtol=1e-5, atol=1e-5)
    assert_params_close(new.params, from_jax_params(jax.device_get(jnew.params), pair.cfg))
    with pytest.raises(ValueError, match="divisible"):
        step(pair.state, _batch(batch=3))


def test_nonfinite_step_is_skipped_like_jax(f32):
    bad = _batch(seed=7)
    bad["image"][1, 2, 3, 4, 0] = np.nan
    jskip, jm = f32.jstep(f32.jstate, bad, jax.random.PRNGKey(0))
    skip, m = f32.step(f32.state, bad)
    assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 1.0
    assert int(skip.step) == int(jskip.step) == 1
    assert int(skip.nonfinite_streak) == int(jskip.nonfinite_streak) == 1
    assert int(skip.opt_state.count) == 0 and _jax_counts(jskip.opt_state) == {0}
    for tree in ("params", "batch_stats", "ema_params"):
        for name, value in getattr(f32.state, tree).items():
            assert torch.equal(getattr(skip, tree)[name], value), (tree, name)
    for name, value in f32.state.opt_state.mu.items():
        assert torch.equal(skip.opt_state.mu[name], value)
    # a second bad step extends the streak; a good one resets it and counts 1
    skip2, _ = f32.step(skip, bad)
    assert int(skip2.nonfinite_streak) == 2 and int(skip2.step) == 2
    jgood, jm2 = f32.jstep(jskip, f32.batch, jax.random.PRNGKey(1))
    good, m2 = f32.step(skip, f32.batch)
    _close_rel(m2["total_loss"], jm2["total_loss"], 1e-5)
    assert int(good.nonfinite_streak) == 0 and int(good.opt_state.count) == 1
    assert int(good.step) == int(jgood.step) == 2
    assert_params_close(good.params, from_jax_params(jax.device_get(jgood.params), f32.cfg))
    # without the skip, the NaN reaches the params
    raw, _ = make_train_step(f32.cfg, f32.model, f32.priors, skip_nonfinite=False)(
        f32.state, bad)
    assert torch.isnan(raw.params["base.features.0.0.weight"]).any()


def test_bf16_train_step_matches_jax():
    # 32^3: at 16^3 the deepest BNs normalise a handful of values per channel
    # and both frameworks' bf16 gradients sit ~60% from their own float32
    # ones, so no bf16 implementation could meet 5e-2 there
    pair = Pair(dtype="bfloat16", input_size=(32, 32, 32))
    jstep = jax_steps.make_train_step(pair.jcfg, pair.jmodel, pair.priors, donate=False,
                                      return_grads=True)
    step = make_train_step(pair.cfg, pair.model, pair.priors, return_grads=True)
    batch = _batch(seed=3, d=32)
    _, jm = jstep(pair.jstate, batch, jax.random.PRNGKey(0))
    new, m = step(pair.state, batch)
    assert pair.model.base.features[1].conv1.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in new.params.values())
    for key in ("total_loss", "conf_loss", "loc_loss"):
        _close_rel(m[key], jm[key], 2e-2)
    ref = from_jax_params(jax.device_get(jm["grads"]), pair.cfg)
    ours = np.concatenate([_np(m["grads"][k]).ravel() for k in ref])
    theirs = np.concatenate([_np(v).ravel() for v in ref.values()])
    assert np.isfinite(ours).all()
    assert np.linalg.norm(ours - theirs) <= 5e-2 * np.linalg.norm(theirs)


@pytest.fixture(scope="module")
def trained(f32):
    """The port's state after one train step (so the BN statistics are not the
    init's), and the JAX package's state on the same weights and statistics."""
    state, _ = f32.step(f32.state, f32.batch)
    return _jax_state(f32.jcfg, {k: v.detach() for k, v in state.state_dict().items()}), state


def _assert_detections_close(det, jdet):
    np.testing.assert_array_equal(det["count"].numpy(), np.asarray(jdet["count"]))
    np.testing.assert_array_equal(det["labels"].numpy(), np.asarray(jdet["labels"]))
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(det[key].numpy(), np.asarray(jdet[key]), rtol=1e-4, atol=1e-5)


def test_eval_step_matches_jax(f32, trained):
    jstate, state = trained
    batch = _batch(seed=11)
    batch["batch_mask"][3] = False
    batch["box_mask"][3] = False
    ref = jax_steps.make_eval_step(f32.jcfg, f32.jmodel, f32.priors)(jstate, batch)
    out = make_eval_step(f32.cfg, f32.model, f32.priors)(state, batch)
    for key in ("total_loss", "conf_loss", "loc_loss"):
        _close_rel(out[key], ref[key], 1e-5)
    assert float(out["n_valid"]) == float(ref["n_valid"]) == 7.0
    _assert_detections_close(out["detections"], ref["detections"])


def test_predict_step_matches_jax(f32, trained):
    jstate, state = trained
    images = _batch(batch=2, seed=12)["image"]
    ref = jax_steps.make_predict_step(f32.jcfg, f32.jmodel, f32.priors, min_score=0.2)(
        jstate, images)
    out = make_predict_step(f32.cfg, f32.model, f32.priors, min_score=0.2)(state, images)
    _assert_detections_close(out, ref)
    assert int(out["count"].sum()) > 0


def test_gathered_steps(f32, trained):
    jstate, state = trained
    data_np = {k: v for k, v in _batch(batch=5, seed=13).items() if k != "batch_mask"}
    data = {k: torch.from_numpy(v) for k, v in data_np.items()}
    idx = [3, 0, 4, 1]
    rows = {k: v[idx] for k, v in data_np.items()}
    plain_state, plain = f32.step(state, rows)
    gathered_state, gathered = make_gathered_train_step(
        f32.cfg, f32.model, f32.priors, return_grads=True, with_detections=True)(
        state, data, torch.tensor(idx))
    for key in ("total_loss", "grad_norm"):
        assert torch.equal(plain[key], gathered[key])
    for name, p in plain_state.params.items():
        assert torch.equal(gathered_state.params[name], p)
    # eval: 99 clamps to the last row, -3 counts from the end (row 2), as
    # dynamic_index_in_dim does; the padded rows are masked out
    pad_idx, valid = np.array([2, 0, 99, -3], np.int32), np.array([True, True, False, False])
    ref = jax_steps.make_gathered_eval_step(f32.jcfg, f32.jmodel, f32.priors)(
        jstate, {k: jnp.asarray(v) for k, v in data_np.items()}, jnp.asarray(pad_idx),
        jnp.asarray(valid))
    out = make_gathered_eval_step(f32.cfg, f32.model, f32.priors)(
        state, data, torch.from_numpy(pad_idx), torch.from_numpy(valid))
    assert float(out["n_valid"]) == float(ref["n_valid"]) == 2.0
    for key in ("total_loss", "conf_loss", "loc_loss"):
        _close_rel(out[key], ref[key], 1e-5)
    _assert_detections_close(out["detections"], ref["detections"])
