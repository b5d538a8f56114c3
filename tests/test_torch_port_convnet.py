"""The port's ConvNet backbone against the JAX package's.

Weights: the JAX package's ``SSD3D.init`` (the ``convnet_maxpool_double``
plan, PReLU alphas drawn by numpy away from their 0.2 init, so that a
wrong alpha shows), carried by ``weights.from_jax_variables``.

- The forward at 32^3, feature layers (6, 9), eval mode, float32: locs and
  scores within 1e-5; every plan's layer list equal to JAX's.
- ``max_pool_3d`` equals JAX's (k3, s2, p1, -inf padding) on odd and even
  sizes, negative inputs included.
- A train step with ``convnet_dropout=0`` against JAX's: the step tests'
  bounds (losses and grad_norm within 1e-5 relative, each gradient leaf
  within 1e-4 of its norm, params by ``assert_params_close``), but for the
  backbone's conv biases: the instance norm after each removes it, so its
  gradient is zero but for rounding, and both frameworks' are held under
  1e-6 of the whole gradient's norm. The train state holds no BN
  statistics.
- Dropout 0.5 in training: the mask's keep rate and its 1 / (1 - p) scale,
  drawn from the step's generator (the same generator state gives the same
  step); with ``grad_accum=2`` on a duplicated sample each micro-batch
  draws its own mask (``tests/test_grad_accum.py``'s check); training
  without a generator raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_step import _batch, _close_rel, _np, assert_params_close

from mslesions3d_tpu.models import SSD3D as JaxSSD3D
from mslesions3d_tpu.models import SSD3DConfig as JaxConfig
from mslesions3d_tpu.models.convnet import convnet_layer_plan as jax_plan
from mslesions3d_tpu.models.layers import max_pool_3d as jax_max_pool_3d
from mslesions3d_tpu.train import steps as jax_steps
from mslesions3d_tpu.train.state import create_train_state as jax_create_train_state
from mslesions3d_tpu_torch.models import layers
from mslesions3d_tpu_torch.models.convnet import CONVNET_CONFIGS, convnet_layer_plan
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.train import create_train_state, make_train_step
from mslesions3d_tpu_torch.weights import from_jax_params, from_jax_variables

KW = dict(n_classes=2, input_channels=1, input_size=(32, 32, 32),
          base_network_config="convnet_maxpool_double", aspect_ratios={6: [1.0], 9: [1.0]},
          lr=1e-3, threshold=(0.1, 0.2), min_score=0.3)


def _jax_state(kw, seed=0):
    jcfg = JaxConfig.create(**kw)
    state = jax_create_train_state(JaxSSD3D(jcfg), jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.array, state.params)
    for name, layer in params["backbone"].items():
        if "prelu_alpha" in layer:
            layer["prelu_alpha"] = rng.uniform(0.05, 0.4, (1,)).astype(np.float32)
    return jcfg, state.replace(params=jax.tree_util.tree_map(jnp.asarray, params)), params


@pytest.mark.parametrize("name", sorted(CONVNET_CONFIGS))
def test_layer_plans_equal_jax(name):
    for cut in (None, 4, 9):
        assert convnet_layer_plan(name, cut) == jax_plan(name, cut)


@pytest.mark.parametrize("size", [(9, 8, 7), (6, 6, 6)])
def test_max_pool_equals_jax(size):
    x = np.random.default_rng(0).normal(-3, 1, (2, *size, 3)).astype(np.float32)
    ref = np.asarray(jax_max_pool_3d(jnp.asarray(x), 3, 2, 1))
    ours = layers.max_pool_3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 4, 1).numpy(), ref)


@pytest.fixture(scope="module")
def convnet():
    jcfg, jstate, params = _jax_state(KW)
    cfg = SSD3DConfig.create(**KW)
    state_dict = from_jax_variables(params, {}, cfg)
    assert "base.features.2.conv.weight" not in state_dict  # layer 2 is a max pool
    model = SSD3D(cfg)
    model.load_state_dict(state_dict)
    return {"jcfg": jcfg, "jstate": jstate, "cfg": cfg, "state_dict": state_dict,
            "model": model.eval()}


def test_forward_matches_jax(convnet):
    x = np.random.default_rng(1).normal(0, 1, (2, 32, 32, 32, 1)).astype(np.float32)
    jstate = convnet["jstate"]
    ref = JaxSSD3D(convnet["jcfg"]).apply({"params": jstate.params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = convnet["model"](torch.from_numpy(x))
    assert ours[0].shape == (2, model_priors(convnet["cfg"]).shape[0], 6)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_train_step_without_dropout_matches_jax():
    kw = dict(KW, convnet_dropout=0.0, input_size=(16, 16, 16),
              aspect_ratios={4: [1.0], 6: [1.0]})
    jcfg, jstate, params = _jax_state(kw, seed=2)
    cfg = SSD3DConfig.create(**kw)
    state = create_train_state(cfg, device="cpu",
                               state_dict=from_jax_variables(params, {}, cfg))
    assert state.batch_stats == {}
    priors = model_priors(cfg)
    batch = _batch(seed=3)
    jnew, jm = jax_steps.make_train_step(jcfg, JaxSSD3D(jcfg), priors, donate=False,
                                         return_grads=True)(jstate, batch,
                                                            jax.random.PRNGKey(0))
    new, m = make_train_step(cfg, SSD3D(cfg), priors, return_grads=True)(state, batch)
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm"):
        _close_rel(m[key], jm[key], 1e-5)
    total = float(jm["grad_norm"])
    for name, ref in from_jax_params(jax.device_get(jm["grads"]), cfg).items():
        if name.startswith("base.") and name.endswith("conv.bias"):
            # the instance norm removes a conv bias: its gradient is 0 but
            # for rounding, in both frameworks
            assert np.abs(_np(ref)).max() < 1e-6 * total
            assert np.abs(_np(m["grads"][name])).max() < 1e-6 * total
            continue
        norm = float(np.linalg.norm(_np(ref)))
        np.testing.assert_allclose(_np(m["grads"][name]), _np(ref), rtol=0,
                                   atol=1e-4 * max(norm, 1e-12), err_msg=name)
    assert_params_close(new.params, from_jax_params(jax.device_get(jnew.params), cfg))
    assert new.batch_stats == {}


def test_dropout_mask_keep_rate_and_scale():
    block = layers.ConvNormActBlock(1, 64, dropout_rate=0.5).train()
    x = torch.randn(2, 1, 8, 8, 8)
    normed = {}

    def run(gen):
        with torch.no_grad():
            block.dropout_rate = 0.0
            normed["x"] = block(x)  # PReLU of the instance norm, no dropout
            block.dropout_rate = 0.5
            return block(x, gen)

    out = run(torch.Generator().manual_seed(0))
    ref = normed["x"]
    # PReLU is positively homogeneous: a kept element is the undropped one x 2
    kept = out != 0
    rate = float(kept.float().mean())
    assert 0.47 < rate < 0.53, rate
    torch.testing.assert_close(out[kept], 2.0 * ref[kept], rtol=1e-6, atol=1e-6)
    assert torch.equal(run(torch.Generator().manual_seed(0)), out)
    assert not torch.equal(run(torch.Generator().manual_seed(1)), out)
    with pytest.raises(ValueError, match="generator"):
        block(x)
    # eval mode: no dropout and no generator needed
    assert torch.equal(block.eval()(x), ref)


def test_micro_batches_draw_distinct_masks():
    kw = dict(KW, convnet_dropout=0.5, input_size=(16, 16, 16),
              aspect_ratios={4: [1.0], 6: [1.0]})
    cfg = SSD3DConfig.create(**kw)
    state = create_train_state(cfg, device="cpu")
    priors = model_priors(cfg)
    one = {k: v[:1] for k, v in _batch(seed=4).items()}
    dup = {k: np.concatenate([v, v]) for k, v in one.items()}
    model = SSD3D(cfg)
    step1 = make_train_step(cfg, model, priors, return_grads=True)
    step2 = make_train_step(cfg, model, priors, return_grads=True, grad_accum=2)
    _, m1 = step1(state, one, torch.Generator().manual_seed(5))
    _, m2 = step2(state, dup, torch.Generator().manual_seed(5))
    diffs = [float((m2["grads"][k] - m1["grads"][k]).abs().max()) for k in m1["grads"]]
    assert max(diffs) > 1e-4  # shared masks would average two equal gradients
    # the same generator state gives the same step
    _, again = step2(state, dup, torch.Generator().manual_seed(5))
    assert torch.equal(again["total_loss"], m2["total_loss"])
    with pytest.raises(ValueError, match="generator"):
        step1(state, one)
