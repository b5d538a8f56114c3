"""The CUDA NMS kernel (K1) against its plain torch version, on the card.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_nms.py

Keep masks are booleans: the kernel must equal the plain version exactly,
at every K: the warp walk up to 2048, the wide walk with 3, 2 and 1 staged
words, and past what one staged word takes (K = 28545, from global memory;
one row there, since the plain version holds K x K pairs).
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch.kernels.build import load_library
from mslesions3d_tpu_torch.kernels.nms import (
    ENTRY_POINTS,
    greedy_nms,
    greedy_nms_cuda,
    plan_nms,
)

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _clustered(rng, n, k, valid_share=0.85):
    centers = rng.uniform(0.2, 0.8, size=(n, 25, 3))
    idx = rng.integers(0, 25, size=(n, k))
    lo = np.clip(np.take_along_axis(centers, idx[..., None], 1)
                 + rng.normal(0, 0.03, (n, k, 3)) - 0.04, 0, 1)
    hi = np.clip(lo + rng.uniform(0.04, 0.12, (n, k, 3)), 0, 1)
    boxes = np.concatenate([lo, hi], -1).astype(np.float32)
    return boxes, rng.uniform(size=(n, k)) < valid_share


def _on_card(boxes, valid):
    return (torch.as_tensor(boxes, device="cuda").contiguous(),
            torch.as_tensor(valid, device="cuda").contiguous())


@pytest.mark.parametrize("k", [1, 31, 64, 65, 146, 200, 1000, 2048, 2049, 3942, 9473, 14337,
                               28545])
def test_kernel_equals_plain(k):
    _need_card()
    boxes, valid = _on_card(*_clustered(np.random.default_rng(k), 6 if k <= 4096 else 1, k))
    before = greedy_nms_cuda.launches
    keep = greedy_nms_cuda(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert greedy_nms_cuda.launches == before + 1
    torch.testing.assert_close(keep, greedy_nms(boxes, valid, 0.5), rtol=0, atol=0)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("stages", [0, 1, 2, 3])
def test_every_wide_walk_equals_plain(stages):
    """The wide walk forced to each staged-word count, at K = 2048 (where
    the warp walk would run) and at the headline's K = 3942 with a row whose
    valid candidates end early."""
    _need_card()
    for k in (2048, 3942):
        boxes, valid = _clustered(np.random.default_rng(stages), 4, k)
        valid[1, k - 700:] = False
        boxes, valid = _on_card(boxes, valid)
        keep = greedy_nms_cuda(boxes, valid, 0.5, plan=plan_nms(k, walk="wide", stages=stages))
        torch.cuda.synchronize()
        torch.testing.assert_close(keep, greedy_nms(boxes, valid, 0.5), rtol=0, atol=0)


def test_plan_smem_matches_the_library():
    """plan_nms's shared memory is what csrc/nms.cu launches with."""
    _need_card()
    lib = load_library("nms", **ENTRY_POINTS)
    for k in (1, 1000, 2048, 2049, 3942, 9472, 9473, 14337, 28544, 28545):
        plan = plan_nms(k)
        stages = -1 if plan.walk == "warp" else plan.stages
        assert lib.msl_nms_walk_smem_bytes(k, stages) == plan.smem


def test_kernel_prefix_and_empty_rows():
    _need_card()
    boxes, _ = _clustered(np.random.default_rng(9), 5, 384)
    valid = np.zeros((5, 384), bool)
    valid[1, :90], valid[2, :200], valid[3, :] = True, True, True
    valid[4, 383] = True  # a lone valid candidate at the very end
    boxes, valid = _on_card(boxes, valid)
    keep = greedy_nms_cuda(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert not keep[0].any()
    torch.testing.assert_close(keep, greedy_nms(boxes, valid, 0.5), rtol=0, atol=0)


@pytest.mark.parametrize("t", [0.0, 0.3, 0.7])
def test_kernel_thresholds(t):
    _need_card()
    boxes, valid = _on_card(*_clustered(np.random.default_rng(2), 8, 300))
    keep = greedy_nms_cuda(boxes, valid, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(keep, greedy_nms(boxes, valid, t), rtol=0, atol=0)


@pytest.mark.parametrize("k", [130, 1000])
def test_kernel_long_suppression_chain(k):
    """Box i suppresses box i + 1 only (IoU 0.54, then 0.25): the greedy
    answer alternates, and every word needs its longest fixpoint."""
    _need_card()
    s = np.float32(0.3)
    lo = np.zeros((2, k, 3), np.float32)
    lo[:, :, 0] = np.arange(k, dtype=np.float32) * s
    boxes = np.concatenate([lo, lo + 1], -1)
    valid = np.ones((2, k), bool)
    valid[1, 5::7] = False
    boxes, valid = _on_card(boxes, valid)
    keep = greedy_nms_cuda(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert keep[0, ::2].all() and not keep[0, 1::2].any()
    torch.testing.assert_close(keep, greedy_nms(boxes, valid, 0.5), rtol=0, atol=0)


def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    boxes, valid = _on_card(*_clustered(np.random.default_rng(0), 2, 50))
    with pytest.raises(ValueError, match="float32"):
        greedy_nms_cuda(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        greedy_nms_cuda(boxes.transpose(0, 1), valid.t(), 0.5)
    with pytest.raises(ValueError, match="same CUDA device"):
        greedy_nms_cuda(boxes, valid.cpu(), 0.5)
    big, big_valid = _on_card(*_clustered(np.random.default_rng(1), 1, 2049))
    with pytest.raises(ValueError, match="warp walk"):
        greedy_nms_cuda(big, big_valid, 0.5, plan=plan_nms(2048))
    # one past the warp walk's 2048, once refused, is served exactly
    keep = greedy_nms_cuda(big, big_valid, 0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(keep, greedy_nms(big, big_valid, 0.5), rtol=0, atol=0)


def test_detector_on_card_matches_cpu_forward():
    """fp32 forward on the card (TF32 off) against the CPU: rtol 1e-4, atol 1e-5."""
    _need_card()
    from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
    from mslesions3d_tpu_torch.serving import Detector

    cfg = SSD3DConfig.create(input_size=(32, 32, 32), width_mult=0.25)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 32, 1),
                                                                  dtype=np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            card = [t.cpu() for t in Detector(cfg, device="cuda").model(x.cuda())]
            host = Detector(cfg, device="cpu").model(x)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for a, b in zip(card, host):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
