"""The port's fused depthwise (K2) plain version against the JAX kernel.

``depthwise_bn_relu`` is held against ``fused_depthwise_bn_relu(...,
interpret=True)`` on the same numpy inputs. Both sum the 27 taps in float32
in the same order; XLA may contract a multiply and an add into one FMA, so
float32 agrees to rtol/atol 1e-5 rather than bit for bit, and a bfloat16
output may then round to the neighbouring value: at most one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mslesions3d_tpu.kernels.depthwise import fold_bn as jax_fold_bn
from mslesions3d_tpu.kernels.depthwise import fused_depthwise_bn_relu
from mslesions3d_tpu_torch.kernels.depthwise import (
    depthwise_bn_relu,
    fold_bn,
    fused_depthwise_bn_relu_cuda,
)

SHAPES = [(2, 6, 8, 8, 128), (1, 1, 8, 8, 128), (1, 2, 8, 8, 128), (1, 3, 8, 8, 128)]


def bf16_ulp(v):
    """One bf16 ulp at the magnitude of v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def numpy_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, c)).astype(np.float32)
    bn = [np.abs(rng.normal(size=c)) + 0.5, rng.normal(size=c), rng.normal(size=c),
          np.abs(rng.normal(size=c)) + 0.5]
    return x, w, [b.astype(np.float32) for b in bn]


def both_sides(shape, dtype, seed):
    """(JAX result, port result) as float32 NDHWC numpy arrays."""
    x, w, bn = numpy_inputs(shape, seed)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    gamma, beta = jax_fold_bn(*(jnp.asarray(b) for b in bn))
    ref = fused_depthwise_bn_relu(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                                  gamma, beta, interpret=True)
    tgamma, tbeta = fold_bn(*(torch.from_numpy(b) for b in bn))
    xt = torch.from_numpy(x).to(tdt).permute(0, 4, 1, 2, 3)
    out = depthwise_bn_relu(xt, torch.from_numpy(w).to(tdt), tgamma, tbeta)
    assert out.dtype == tdt and out.shape == xt.shape
    assert out.is_contiguous(memory_format=torch.channels_last_3d)
    return np.asarray(ref, np.float32), out.permute(0, 2, 3, 4, 1).float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(shape, dtype):
    ref, ours = both_sides(shape, dtype, seed=shape[1])
    assert float(np.abs(ref).max()) > 1.0 and float((ref == 0).mean()) > 0.1  # ReLU bites
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    else:
        diff = np.abs(ours - ref)
        assert (diff <= bf16_ulp(np.maximum(np.abs(ours), np.abs(ref)))).all(), diff.max()


def test_fold_bn_matches_jax():
    """XLA's and torch's rsqrt may differ by an ulp, and beta = bias - mean *
    gamma cancels, so beta agrees to an absolute 1e-6 (|mean * gamma| < 4)."""
    _, _, bn = numpy_inputs((1, 1, 1, 1, 64), seed=4)
    ref = jax_fold_bn(*(jnp.asarray(b) for b in bn))
    ours = fold_bn(*(torch.from_numpy(b) for b in bn))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version():
    x, w, bn = numpy_inputs((2, 3, 4, 4, 128), seed=1)
    gamma, beta = fold_bn(*(torch.from_numpy(b) for b in bn))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    before = fused_depthwise_bn_relu_cuda.launches
    out = fused_depthwise_bn_relu_cuda(xt, torch.from_numpy(w), gamma, beta)
    assert fused_depthwise_bn_relu_cuda.launches == before
    assert torch.equal(out, depthwise_bn_relu(xt, torch.from_numpy(w), gamma, beta))


def test_wrapper_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a card is refused, not computed."""
    x = torch.empty((1, 128, 2, 2, 2), device="meta")
    w, v = torch.empty((3, 3, 3, 128), device="meta"), torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_depthwise_bn_relu_cuda(x, w, v, v)
