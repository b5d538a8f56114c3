"""The frozen work counts, pinned by hand-worked values."""

from __future__ import annotations

import pytest

from perfbench.metrics import _counts as counts


def test_forward_at_96_with_two_boxes():
    # stem 48^3 x 32 x 27; blocks: 24^3 (32 dw, 32 -> 64), 12^3 (64, 64 -> 128),
    # 12^3 (128, 128 -> 128), 6^3 (128, 128 -> 256), 6^3 (256, 256 -> 256),
    # 3^3 (256, 256 -> 512), 3^3 (512, 512 -> 512); heads 2 x (6 + 2) x 27 on
    # 12^3 x 128, 6^3 x 256, 3^3 x 512
    flops, nbytes = counts.forward_count((96, 96, 96))
    assert flops == 694_586_880  # 0.6946 GFLOP
    assert nbytes == pytest.approx(11.84e6, rel=1e-3)


def test_forward_at_64_with_three_boxes():
    flops, _ = counts.forward_count((64, 64, 64), boxes_per_location=3, elem_bytes=4)
    assert flops == 242_962_432  # 0.2430 GFLOP


def test_kernel_bounds_at_the_headline_batch():
    # chip smoke test's numbers for K2 and K3 at batch 32 (PERF.md's kernel table)
    assert counts.dw_bound((32, 128, 12, 12, 12), 2) == (pytest.approx(8.4536e-6, rel=1e-4),
                                                         "bytes")
    tail = [(128, 256, 2), (256, 256, 1), (256, 512, 2), (512, 512, 1)]
    assert counts.tail_bound((32, 128, 12, 12, 12), 2, tail, [1, 3])[0] == pytest.approx(
        5.8645e-6, rel=1e-4)


def test_nms_bound_counts_only_the_pairs_the_data_needs():
    full, _ = counts.nms_bound(2, 1000, [1000, 1000])
    half, _ = counts.nms_bound(2, 1000, [500, 500])
    ops = 2 * 1000 * 999 / 2 * counts.NMS_OPS_PER_PAIR
    assert full == pytest.approx(max(ops / counts.PEAK_FP32_FLOPS,
                                     2 * 1000 * 26 / counts.PEAK_BYTES_PER_S))
    assert half < full


def test_depthwise_convs_of_blocks_one_and_two():
    # 318 MB at 3.35 TB/s: the 48^3 x 32 and 24^3 x 64 inputs at batch 32, bf16
    one, _ = counts.dw_conv_bound((32, 32, 48, 48, 48), 2, 2)
    two, _ = counts.dw_conv_bound((32, 64, 24, 24, 24), 2, 2)
    assert (one + two) * counts.PEAK_BYTES_PER_S == pytest.approx(318.5e6, rel=1e-2)


def test_share_is_silent_where_nothing_ran():
    assert counts.share(1.0, 0.0) is None
    assert counts.share(1.0, 4.0) == 25.0
