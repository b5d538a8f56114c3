"""The CUDA fused depthwise kernel (K2) against its plain torch version, on the card.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_depthwise.py

The kernel sums the taps in the plain version's order with round-to-nearest
float32 operations (no FMA), so the two are equal bit for bit, on every tile
``plan_depthwise`` picks or is given, and on the direct variant.
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.kernels.depthwise import (
    depthwise_bn_relu,
    fused_depthwise_bn_relu_cuda,
    plan_depthwise,
)

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(shape, dtype, seed=0):
    """x (B, C, D, H, W) channels_last_3d, weights, gamma, beta on the card."""
    rng = np.random.default_rng(seed)
    b, c, d, h, w = shape
    x = torch.from_numpy(rng.normal(size=(b, d, h, w, c)).astype(np.float32))
    weights = torch.from_numpy(rng.normal(0, 0.3, (3, 3, 3, c)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32))
    x = x.to("cuda", dtype).permute(0, 4, 1, 2, 3)
    return x, weights.to("cuda", dtype), gamma.cuda(), beta.cuda()


def _check(x, w, gamma, beta, plan=None):
    """One launch, counted once, bit for bit with the plain version."""
    before = fused_depthwise_bn_relu_cuda.launches
    out = fused_depthwise_bn_relu_cuda(x, w, gamma, beta, plan)
    torch.cuda.synchronize()
    assert fused_depthwise_bn_relu_cuda.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    assert out.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(out, depthwise_bn_relu(x, w, gamma, beta), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 128, 12, 12, 12), (8, 256, 6, 6, 6), (8, 512, 3, 3, 3),
                                   (2, 128, 1, 8, 8), (2, 128, 2, 5, 7), (3, 130, 3, 4, 4),
                                   (1, 6, 2, 3, 3), (32, 128, 12, 12, 12), (1, 128, 16, 16, 16),
                                   (2, 128, 4, 9, 17), (3, 256, 1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_equals_plain(shape, dtype):
    _need_card()
    assert plan_depthwise(dtype, shape).variant == "tiled"
    _check(*_inputs(shape, dtype, seed=shape[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tile", [dict(td=2, th=3), dict(cs=32, td=3, th=4),
                                  dict(cs=4, td=1, th=1), dict(variant="direct")],
                         ids=lambda t: "-".join(map(str, t.values())))
def test_given_tiles_equal_plain(tile, dtype):
    """Ragged slabs (5 = 2+2+1, 3+2), bands (9 = 3+3+3, 4+4+1), channel
    slices (130 = 64+64+2, 32x4+2, 4x32+2) and the direct variant."""
    _need_card()
    shape = (2, 130, 5, 9, 7)
    _check(*_inputs(shape, dtype, seed=3), plan=plan_depthwise(dtype, shape, **tile))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_widest_rows_take_the_direct_variant(dtype):
    _need_card()
    shape = (1, 4, 1, 2, 7000)
    assert plan_depthwise(dtype, shape).variant == "direct"
    _check(*_inputs(shape, dtype, seed=4))


def test_x_aligned_to_4_bytes_copies_4_bytes():
    _need_card()
    _, w, gamma, beta = _inputs((2, 128, 5, 6, 7), torch.bfloat16)
    base = torch.randn(2 * 5 * 6 * 7 * 128 + 2, device="cuda").bfloat16()
    x = base[2:].view(2, 5, 6, 7, 128).permute(0, 4, 1, 2, 3)  # 4 bytes past 16-byte alignment
    assert x.data_ptr() % 16 == 4 and plan_depthwise(x.dtype, x.shape, 4).vec == 4
    _check(x, w, gamma, beta)
    with pytest.raises(ValueError, match="is not a plan for x"):
        fused_depthwise_bn_relu_cuda(x, w, gamma, beta, plan_depthwise(x.dtype, x.shape))


def test_kernel_keeps_nan_like_torch_relu():
    _need_card()
    x, w, gamma, beta = _inputs((1, 128, 3, 3, 3), torch.float32)
    x[0, 5, 1, 1, 1] = float("nan")
    out = fused_depthwise_bn_relu_cuda(x, w, gamma, beta)
    torch.cuda.synchronize()
    plain = depthwise_bn_relu(x, w, gamma, beta)
    assert torch.isnan(out[0, 5]).sum() == 27
    torch.testing.assert_close(out, plain, rtol=0, atol=0, equal_nan=True)


def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    x, w, gamma, beta = _inputs((2, 128, 4, 4, 4), torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last_3d"):
        fused_depthwise_bn_relu_cuda(x.contiguous(), w, gamma, beta)
    with pytest.raises(ValueError, match="both be float32 or both bfloat16"):
        fused_depthwise_bn_relu_cuda(x, w.float(), gamma, beta)
    with pytest.raises(ValueError, match="both be float32 or both bfloat16"):
        fused_depthwise_bn_relu_cuda(x.half(), w.half(), gamma, beta)
    with pytest.raises(ValueError, match="gamma and beta must be float32"):
        fused_depthwise_bn_relu_cuda(x, w, gamma.bfloat16(), beta)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_depthwise_bn_relu_cuda(x, w.cpu(), gamma, beta)
    with pytest.raises(ValueError, match="even C"):
        xo, wo, go, bo = _inputs((1, 3, 2, 2, 2), torch.float32)
        fused_depthwise_bn_relu_cuda(xo, wo, go, bo)
    with pytest.raises(ValueError, match=r"weights \(3, 3, 3, 128\)"):
        fused_depthwise_bn_relu_cuda(x, w[:2], gamma, beta)
