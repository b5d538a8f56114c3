"""The training path on the card: a float32 train step against the CPU's, K1
in the eval and metric steps against the plain NMS, and a bf16 step at the
bench's training geometry.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_train.py

Tolerances, float32 at 16^3, width 0.25, batch 8, TF32 off: the losses and
grad_norm within 1e-5 relative, every gradient leaf within 1e-4 of the
leaf's norm, BN statistics within 1e-5, params within 1e-5 on at least
99.9% of elements and within 4 lr on all (Adam's first step moves an
element by about lr whatever its gradient's size; see
``tests/test_torch_port_train_step.py``). Detections: equal.
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.data.augment import AugmentConfig
from mslesions3d_tpu_torch.kernels.nms import greedy_nms, greedy_nms_cuda
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.ops.nms import nms_candidates, select_detections
from mslesions3d_tpu_torch.train import create_train_state, make_eval_step, make_train_step

pytestmark = pytest.mark.gpu

LR = 1e-3
SMALL = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25, lr=LR,
             threshold=(0.1, 0.2), min_score=0.3)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _source_state_dict(config, seed=0):
    """Init weights with the BN affine and running statistics randomised."""
    state = SSD3D(config, generator=torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed)
    for key in [k for k in state if k.endswith("running_mean")]:
        prefix, c = key[: -len("running_mean")], state[key].shape[0]
        for name, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.2, 0.2),
                             ("running_mean", -0.3, 0.3), ("running_var", 0.5, 2.0)):
            state[prefix + name] = torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32))
    return state


def _batch(batch=8, seed=0, d=16):
    """Seeded volumes with two painted cubes each and their boxes."""
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
    return {"image": images, "boxes": boxes, "labels": labels, "box_mask": mask}


def test_f32_train_step_on_the_card_matches_the_cpu(no_tf32):
    _need_card()
    config = SSD3DConfig.create(**SMALL)
    source, batch = _source_state_dict(config), _batch()
    out = {}
    for device in ("cpu", "cuda"):
        state = create_train_state(config, device=device, state_dict=source)
        step = make_train_step(config, SSD3D(config), model_priors(config), return_grads=True)
        new, m = step(state, batch)
        assert new.device.type == device
        out[device] = new, m
    (cpu, cm), (card, gm) = out["cpu"], out["cuda"]
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm"):
        np.testing.assert_allclose(float(gm[key]), float(cm[key]), rtol=1e-5, err_msg=key)
    for name, g in cm["grads"].items():
        atol = 1e-4 * max(float(g.norm()), 1e-12)
        torch.testing.assert_close(gm["grads"][name].cpu(), g, rtol=0, atol=atol, msg=name)
    for name, s in cpu.batch_stats.items():
        torch.testing.assert_close(card.batch_stats[name].cpu(), s, rtol=1e-5, atol=1e-5)
    diffs = torch.cat([(card.params[k].cpu() - p).abs().flatten() for k, p in cpu.params.items()])
    assert float((diffs <= 1e-5).float().mean()) >= 0.999
    assert float(diffs.max()) <= 4 * LR


@pytest.mark.parametrize("which", ["eval", "with_detections"])
def test_step_detections_with_k1_equal_the_plain_nms(which):
    _need_card()
    config = SSD3DConfig.create(**SMALL)
    priors = model_priors(config)
    model = SSD3D(config)
    state = create_train_state(config, device="cuda", state_dict=_source_state_dict(config))
    batch = _batch(seed=1)
    state, _ = make_train_step(config, model, priors)(state, batch)  # BN statistics move
    outs = []
    handle = model.register_forward_hook(
        lambda module, args, out: outs.append(tuple(t.detach() for t in out)))
    try:
        before = greedy_nms_cuda.launches
        if which == "eval":
            det = make_eval_step(config, model, priors)(state, batch)["detections"]
        else:
            _, m = make_train_step(config, model, priors, with_detections=True)(state, batch)
            det = m["detections"]
        torch.cuda.synchronize()
        assert greedy_nms_cuda.launches == before + 1
    finally:
        handle.remove()
    (locs, scores), = outs
    kw = dict(n_classes=config.n_classes, top_k=config.top_k)
    boxes, cscores, valid = nms_candidates(locs, scores, torch.from_numpy(priors).cuda(),
                                           min_score=config.min_score, **kw)
    plain = select_detections(boxes, cscores, greedy_nms(boxes, valid, config.max_overlap), **kw)
    for key, value in plain.items():
        assert torch.equal(det[key], value), key
    assert int(det["count"].sum()) > 0


def test_bf16_train_step_at_the_training_geometry():
    _need_card()
    config = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(64, 64, 64),
                                dtype="bfloat16", lr=LR, threshold=[0.1, 0.2])
    state = create_train_state(config, seed=0)
    assert state.device.type == "cuda"
    step = make_train_step(config, SSD3D(config), model_priors(config),
                           augment=AugmentConfig(flip_axes=(0, 1, 2), rot90_planes=((1, 2),)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    new, m = step(state, _batch(batch=8, seed=2, d=64), gen)
    assert torch.isfinite(m["total_loss"]) and float(m["nonfinite"]) == 0.0
    assert float(m["n_positives"]) == 16.0
    assert all(p.dtype == torch.float32 for p in new.params.values())
    assert not torch.equal(new.params["base.features.0.0.weight"],
                           state.params["base.features.0.0.weight"])
    assert int(new.step) == int(new.opt_state.count) == 1
