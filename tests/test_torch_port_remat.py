"""``remat`` in training: the stem recomputed in chunks of samples, the
depthwise-separable blocks under ``torch.utils.checkpoint``.

- float32, 16^3, width 0.25: ``remat=True`` gives the same losses,
  gradients and BN running statistics as ``remat=False`` after one step and
  after three, within 1e-6 relative (the recompute must not move the BN
  statistics a second time, and must use the first pass's batch
  statistics).
- The remat train step against the JAX package's ``remat=True`` step, at
  the step tests' bounds.
- ``layers.conv_bn_relu_train`` (the training conv + BN + ReLU, in chunks
  of samples) against the plain modules, for the stem's strided conv with
  the fast variance and a strided depthwise conv with the centred one, at
  one, an uneven three and all samples a chunk: output, running statistics
  and the gradients of the input and every parameter in float32 no further
  from a float64 run of the plain modules than twice the plain float32
  run's own distance (or 1e-6 relative); with the conv output recomputed
  (remat's stem) equal to the kept one, bit for bit.
- No MobileNet block draws at random under remat (``checkpoint`` runs with
  ``preserve_rng_state=False``, so a draw would differ in the recompute): a
  train forward and backward leaves a generator handed to the model and the
  global RNG where they were.
- Eval mode and ``no_grad`` run the plain forward.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn
from test_torch_port_train_step import Pair, _batch, _close_rel, _np, assert_params_close

from mslesions3d_tpu.train import steps as jax_steps
from mslesions3d_tpu_torch.models import layers, mobilenet
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig
from mslesions3d_tpu_torch.train import make_train_step
from mslesions3d_tpu_torch.weights import from_jax_batch_stats, from_jax_params


def _rel_close(a, b, rtol=1e-6):
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(float(np.abs(b).max()), 1e-30))


@pytest.fixture(scope="module")
def pairs():
    return {remat: Pair(remat=remat) for remat in (False, True)}


@pytest.mark.parametrize("steps", [1, 3])
def test_remat_equals_plain(pairs, steps):
    states, metrics = {}, {}
    for remat, pair in pairs.items():
        step = make_train_step(pair.cfg, pair.model, pair.priors, return_grads=True)
        state = pair.state
        for i in range(steps):
            state, m = step(state, _batch(seed=i))
        states[remat], metrics[remat] = state, m
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm"):
        _rel_close(metrics[True][key], metrics[False][key])
    for name, g in metrics[False]["grads"].items():
        _rel_close(metrics[True]["grads"][name], g)
    for name, s in states[False].batch_stats.items():
        _rel_close(states[True].batch_stats[name], s)
        assert not torch.equal(s, pairs[False].state.batch_stats[name])
    for name, p in states[False].params.items():
        _rel_close(states[True].params[name], p)


def test_remat_step_matches_jax(pairs):
    pair = pairs[True]
    assert pair.jcfg.remat and pair.model.base.remat
    jstep = jax_steps.make_train_step(pair.jcfg, pair.jmodel, pair.priors, donate=False,
                                      return_grads=True)
    step = make_train_step(pair.cfg, pair.model, pair.priors, return_grads=True)
    batch = _batch(seed=4)
    jnew, jm = jstep(pair.jstate, batch, jax.random.PRNGKey(0))
    new, m = step(pair.state, batch)
    for key in ("total_loss", "conf_loss", "loc_loss", "grad_norm"):
        _close_rel(m[key], jm[key], 1e-5)
    for name, ref in from_jax_params(jax.device_get(jm["grads"]), pair.cfg).items():
        norm = float(np.linalg.norm(_np(ref)))
        np.testing.assert_allclose(_np(m["grads"][name]), _np(ref), rtol=0,
                                   atol=1e-4 * max(norm, 1e-12), err_msg=name)
    ref_stats = from_jax_batch_stats(jnew.params, jax.device_get(jnew.batch_stats))
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(_np(new.batch_stats[name]), _np(ref), rtol=1e-5, atol=1e-5)
    assert_params_close(new.params, from_jax_params(jax.device_get(jnew.params), pair.cfg))


def _conv_bn_relu_run(conv, bn, x, grad_out, keep):
    """Output, gradients (input, conv weight, BN weight and bias) and the
    moved running statistics; ``keep`` None runs the plain modules."""
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)
    x = x.clone().requires_grad_()
    out = (torch.relu(bn(conv(x))) if keep is None
           else layers.conv_bn_relu_train(conv, bn, x, keep=keep))
    grads = torch.autograd.grad(out, [x, conv.weight, bn.weight, bn.bias], grad_out)
    return [out.detach(), *grads, bn.running_mean.clone(), bn.running_var.clone()]


@pytest.mark.parametrize("samples_a_chunk", [1, 3, 8])
@pytest.mark.parametrize("kind", ["stem", "depthwise"])
def test_conv_bn_relu_train_equals_plain(monkeypatch, kind, samples_a_chunk):
    torch.manual_seed(0)
    if kind == "stem":  # strided conv, flax's BN (fast variance)
        conv, bn = nn.Conv3d(2, 8, 3, 2, 1, bias=False), layers.BatchNorm3d(8, fast_variance=True)
    else:               # strided depthwise conv, the blocks' BN (centred variance)
        conv, bn = nn.Conv3d(8, 8, 3, 2, 1, groups=8, bias=False), layers.BatchNorm3d(8)
    bn.train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.2, 0.2)
    # 7 samples of 8 channels at 8^3 after the stride; a chunk's size
    # counts the larger of a sample's input and output
    x = torch.randn(7, conv.in_channels, 16, 16, 16).contiguous(
        memory_format=torch.channels_last_3d)
    monkeypatch.setattr(layers, "CHUNK_ELEMENTS", samples_a_chunk * max(x[0].numel(), 8 * 8 ** 3))
    grad_out = torch.randn(7, 8, 8, 8, 8)
    plain = _conv_bn_relu_run(conv, bn, x, grad_out, None)
    kept = _conv_bn_relu_run(conv, bn, x, grad_out, True)
    recomputed = _conv_bn_relu_run(conv, bn, x, grad_out, False)
    reference = _conv_bn_relu_run(conv.double(), bn.double(), x.double(), grad_out.double(),
                                  None)
    assert not torch.equal(plain[-2], torch.zeros(8))
    for ours, theirs, ref, again in zip(kept, plain, reference, recomputed):
        scale = float(ref.abs().max())
        error = float((ours.double() - ref).abs().max()) / scale
        plain_error = float((theirs.double() - ref).abs().max()) / scale
        # float32 rounding: no worse than twice the plain modules' own
        assert error <= max(2 * plain_error, 1e-6), (error, plain_error)
        assert torch.equal(again, ours)


def test_remat_draws_from_no_generator():
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(16, 16, 16),
                             width_mult=0.25, remat=True)
    model = SSD3D(cfg).train()
    x = torch.randn(2, 16, 16, 16, 1)
    generator = torch.Generator().manual_seed(5)
    before, global_before = generator.get_state(), torch.get_rng_state()
    locs, scores = model(x, generator)
    (locs.square().sum() + scores.square().sum()).backward()
    assert all(p.grad is not None for p in model.base.parameters())
    assert torch.equal(generator.get_state(), before)
    assert torch.equal(torch.get_rng_state(), global_before)


def test_remat_is_training_only(monkeypatch):
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(16, 16, 16),
                             width_mult=0.25, remat=True)
    model = SSD3D(cfg)
    x = torch.randn(2, 16, 16, 16, 1)
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return layers.checkpointed(*args, **kwargs)

    monkeypatch.setattr(mobilenet, "checkpointed", counted)
    with torch.no_grad():
        model.eval()(x)
        model.train()(x)
    assert calls == []
    model.train()(x)
    assert len(calls) == len(model.base.features)
