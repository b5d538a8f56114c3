"""The fused tail's planner (K3): which kernel takes each chain, and how.

``plan_tail`` is pure Python, so it runs here without a card. It picks the
cluster kernel (one launch for the whole chain) for a bf16 chain whose
per-CTA buffers fit a Hopper block's shared memory, the per-block
tensor-core kernel for a larger bf16 input, and the per-block float32 kernel
for float32. The buffer sizes below are recomputed from the kernel's own
use of them (csrc/tail.cu, tail_cluster_kernel), not from the planner.
"""

import math

import pytest
import torch

from mslesions3d_tpu_torch.kernels.tail import (
    CLUSTER,
    MAX_C_IN,
    MAX_CLUSTER_LAYERS,
    SMEM_MAX,
    channel_slices,
    plan_tail,
)

HEADLINE_TAIL = [(128, 256, 2), (256, 256, 1), (256, 512, 2), (512, 512, 1)]
ODD_WIDTHS = [(64, 200, 2), (200, 96, 1), (96, 40, 2)]
# the shapes of tests/test_torch_gpu_tail.py
CARD_SHAPES = {
    "narrow": ([(128, 128, 2), (128, 128, 1)], (2, 128, 4, 4, 4)),
    "odd-dims": ([(128, 256, 1), (256, 256, 2)], (3, 128, 5, 6, 7)),
    "odd-widths": (ODD_WIDTHS, (2, 64, 9, 9, 9)),
    "headline": (HEADLINE_TAIL, (8, 128, 12, 12, 12)),
}
LARGE = {
    "headline-widths": (HEADLINE_TAIL, (1, 128, 24, 24, 24)),
    "odd-widths": (ODD_WIDTHS, (1, 64, 24, 24, 24)),
}


def _r16(n):
    return -(-n // 16) * 16


def _needs(shape, specs):
    """Bytes each cluster buffer must hold, from the kernel's indexing."""
    dims, act, y, work = shape[2:], 0, 0, 0
    for i, (cin, cout, stride) in enumerate(specs):
        padded_in = math.prod(n + 2 for n in dims)  # with the zero halo
        dims = [(n - 1) // stride + 1 for n in dims]
        vout = math.prod(dims)
        s_in, s_out = -(-cin // CLUSTER), -(-cout // CLUSTER)
        if i == 0:
            work = max(work, padded_in * s_in * 2)  # work + p * s_in + c, bf16
        if i + 1 < len(specs):
            act = max(act, math.prod(n + 2 for n in dims) * s_out * 4)  # float32, halo'd
        y = max(y, vout * s_in * 2)  # y[v * s + c], bf16
        kpad, mpad, npad = _r16(cin), _r16(vout), _r16(s_out)
        work = max(work, mpad * (kpad + 8) * 2 + kpad * (npad + 8) * 2)  # A, then B
    return act, y, work


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_headline_takes_one_cluster_launch(batch):
    plan = plan_tail(torch.bfloat16, (batch, 128, 12, 12, 12), HEADLINE_TAIL)
    assert (plan.variant, plan.launches) == ("cluster", 1)
    assert plan.smem == 231_936 <= SMEM_MAX  # the same per CTA at every batch
    assert plan.slices == ((16, 32), (32, 32), (32, 64), (64, 64))


@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_card_test_shapes(name):
    specs, shape = CARD_SHAPES[name]
    bf16 = plan_tail(torch.bfloat16, shape, specs)
    assert (bf16.variant, bf16.launches) == ("cluster", 1)
    f32 = plan_tail(torch.float32, shape, specs)
    assert (f32.variant, f32.launches) == ("block_f32", len(specs))
    assert f32.smem == 8 * max(cin for cin, _, _ in specs) * 4 <= 48 * 1024


@pytest.mark.parametrize("name", list(LARGE))
def test_larger_input_takes_the_per_block_variant(name):
    specs, shape = LARGE[name]
    assert sum(_needs(shape, specs)) > SMEM_MAX  # a sample's chain cannot fit a cluster
    plan = plan_tail(torch.bfloat16, shape, specs)
    assert (plan.variant, plan.launches) == ("block_mma", len(specs))
    assert plan.smem <= SMEM_MAX


def test_chain_longer_than_the_cluster_table_takes_the_per_block_variant():
    specs = [(16, 16, 1)] * (MAX_CLUSTER_LAYERS + 1)
    assert plan_tail(torch.bfloat16, (1, 16, 2, 2, 2), specs).variant == "block_mma"
    assert plan_tail(torch.bfloat16, (1, 16, 2, 2, 2), specs[:-1]).variant == "cluster"


@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_cluster_buffers_hold_every_block(name):
    specs, shape = CARD_SHAPES[name]
    plan = plan_tail(torch.bfloat16, shape, specs)
    act, y0, y1, work, total = plan.offsets
    assert all(o % 16 == 0 for o in plan.offsets)  # 16-byte copies land aligned
    need_act, need_y, need_work = _needs(shape, specs)
    assert y0 - act >= need_act and y1 - y0 >= need_y and work - y1 >= need_y
    assert total - work >= need_work and total == plan.smem <= SMEM_MAX


def test_per_block_variant_fits_at_the_widest_input():
    specs = [(MAX_C_IN, 256, 1)]
    for dtype in (torch.bfloat16, torch.float32):
        plan = plan_tail(dtype, (1, MAX_C_IN, 64, 64, 64), specs)
        assert plan.variant != "cluster" and plan.launches == 1
        assert plan.smem <= (SMEM_MAX if dtype == torch.bfloat16 else 48 * 1024)


@pytest.mark.parametrize("c", [1, 5, 8, 40, 64, 96, 128, 200, 256, 512, 1000, MAX_C_IN])
def test_channel_slices_cover_c_exactly(c):
    slices = channel_slices(c)
    assert len(slices) == CLUSTER
    assert slices[0][0] == 0 and slices[-1][1] == c
    for (lo, hi), (nxt, _) in zip(slices, slices[1:]):
        assert lo <= hi == nxt  # contiguous, disjoint, in rank order
    assert max(hi - lo for lo, hi in slices) == -(-c // CLUSTER)
    assert sum(hi - lo for lo, hi in slices) == c
