"""The CUDA fused tail kernel (K3) against its plain torch version, on the card.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_tail.py

The kernels' depthwise sums equal the plain version's bit for bit; their
pointwise sums run in another order than torch.matmul's (in bf16 on the
tensor cores). ``plan_tail`` picks the kernel: at the headline one cluster
launch for the whole chain, for a larger input one tensor-core launch per
block, in float32 one CUDA-core launch per block. In float32 the
maps agree to rtol 1e-5, atol 1e-5. In bfloat16 a float32 difference of an
ulp can tip the bf16 rounding of a depthwise output, and the chain spreads
it (``tests/test_torch_port_tail.py`` sets out why): each element is held
within one bf16 ulp at the larger of its magnitude and a quarter of the
map's largest, and the share
of differing elements below 1% for the first emitted map and 15% for the
second.
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.kernels.tail import MAX_C_IN, fused_tail_cuda, plan_tail, tail_reference

pytestmark = pytest.mark.gpu

HEADLINE_TAIL = [(128, 256, 2), (256, 256, 1), (256, 512, 2), (512, 512, 1)]
MAX_DIFFERING = (0.01, 0.15)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _layers(plan, dtype, seed=1):
    layers = []
    for j, (cin, cout, stride) in enumerate(plan):
        r = np.random.default_rng(seed + j)

        def t(a, dt=torch.float32):
            return torch.from_numpy(a.astype(np.float32)).to("cuda", dt)

        layers.append(dict(
            dw_w=t(r.normal(0, 0.2, (3, 3, 3, cin)), dtype),
            dw_gamma=t(r.normal(1, 0.1, cin)), dw_beta=t(r.normal(0, 0.1, cin)),
            pw_w=t(r.normal(0, 0.1, (cin, cout)), dtype),
            pw_gamma=t(r.normal(1, 0.1, cout)), pw_beta=t(r.normal(0, 0.1, cout)),
            stride=stride,
        ))
    return layers


def _x(shape, dtype, seed=0):
    b, c, d, h, w = shape
    x = np.random.default_rng(seed).normal(size=(b, d, h, w, c)).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype).permute(0, 4, 1, 2, 3)


def _bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(float(v.abs().max()) / 4))) - 7)


def _check_bf16(outs, refs):
    for out, ref, bound in zip(outs, refs, MAX_DIFFERING):
        assert out.dtype == torch.bfloat16 and out.shape == ref.shape
        assert out.is_contiguous(memory_format=torch.channels_last_3d)
        a, b = out.float(), ref.float()
        diff = (a - b).abs()
        assert bool((diff <= _bf16_ulp(torch.maximum(a.abs(), b.abs()))).all())
        assert float((diff > 0).float().mean()) < bound


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_headline_tail_bf16(batch):
    _need_card()
    x, layers = _x((batch, 128, 12, 12, 12), torch.bfloat16), _layers(HEADLINE_TAIL, torch.bfloat16)
    assert plan_tail(x.dtype, x.shape, HEADLINE_TAIL).variant == "cluster"
    before = fused_tail_cuda.launches
    outs = fused_tail_cuda(x, layers, (1, 3))
    torch.cuda.synchronize()
    assert fused_tail_cuda.launches == before + 1
    _check_bf16(outs, tail_reference(x, layers, (1, 3)))


SHAPES = [
    ([(128, 128, 2), (128, 128, 1)], (2, 128, 4, 4, 4), (1,)),
    ([(128, 256, 1), (256, 256, 2)], (3, 128, 5, 6, 7), (0, 1)),
    ([(64, 200, 2), (200, 96, 1), (96, 40, 2)], (2, 64, 9, 9, 9), (0, 2)),
    (HEADLINE_TAIL, (8, 128, 12, 12, 12), (1, 3)),
]
SHAPE_IDS = ["narrow", "odd-dims", "odd-widths", "headline"]


@pytest.mark.parametrize("plan,shape,emit", SHAPES, ids=SHAPE_IDS)
def test_kernel_bf16_within_bound(plan, shape, emit):
    """Every shape the float32 test takes, in bf16 on the cluster kernel."""
    _need_card()
    x, layers = _x(shape, torch.bfloat16), _layers(plan, torch.bfloat16)
    assert plan_tail(x.dtype, x.shape, plan).variant == "cluster"
    outs = fused_tail_cuda(x, layers, emit)
    torch.cuda.synchronize()
    assert len(outs) == len(emit)
    _check_bf16(outs, tail_reference(x, layers, emit))


@pytest.mark.parametrize("plan,shape,emit", [
    (HEADLINE_TAIL, (1, 128, 24, 24, 24), (1, 3)),
    ([(64, 200, 2), (200, 96, 1), (96, 40, 2)], (1, 64, 24, 24, 24), (0, 2)),
], ids=["headline-widths", "odd-widths"])
def test_per_block_variant_bf16(plan, shape, emit):
    """An input too large for a cluster's shared memory: one tensor-core launch per block."""
    _need_card()
    x, layers = _x(shape, torch.bfloat16), _layers(plan, torch.bfloat16)
    assert plan_tail(x.dtype, x.shape, plan).variant == "block_mma"
    before = fused_tail_cuda.launches
    outs = fused_tail_cuda(x, layers, emit)
    torch.cuda.synchronize()
    assert fused_tail_cuda.launches == before + len(plan)
    _check_bf16(outs, tail_reference(x, layers, emit))


@pytest.mark.parametrize("plan,shape,emit", SHAPES, ids=SHAPE_IDS)
def test_kernel_f32_close_to_plain(plan, shape, emit):
    _need_card()
    x, layers = _x(shape, torch.float32), _layers(plan, torch.float32)
    before = fused_tail_cuda.launches
    outs = fused_tail_cuda(x, layers, emit)
    torch.cuda.synchronize()
    refs = tail_reference(x, layers, emit)
    assert len(outs) == len(emit) and fused_tail_cuda.launches == before + len(plan)
    for out, ref in zip(outs, refs):
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    x, layers = _x((1, 128, 4, 4, 4), torch.bfloat16), _layers([(128, 128, 2)], torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last_3d"):
        fused_tail_cuda(x.contiguous(), layers, (0,))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_tail_cuda(x.half(), layers, (0,))
    with pytest.raises(ValueError, match="emit"):
        fused_tail_cuda(x, layers, (1,))
    with pytest.raises(ValueError, match="x's CUDA device"):
        fused_tail_cuda(x, [dict(layers[0], pw_w=layers[0]["pw_w"].cpu())], (0,))
    with pytest.raises(ValueError, match="stride 3"):
        fused_tail_cuda(x, [dict(layers[0], stride=3)], (0,))
    with pytest.raises(ValueError, match=r"expected dw_w \(3, 3, 3, 128\)"):
        fused_tail_cuda(x, _layers([(64, 128, 1)], torch.bfloat16), (0,))
    wide = _layers([(MAX_C_IN + 2, 128, 1)], torch.float32)
    with pytest.raises(ValueError, match=f"at most {MAX_C_IN}"):
        fused_tail_cuda(_x((1, MAX_C_IN + 2, 2, 2, 2), torch.float32), wide, (0,))
