"""Bundles and the int8 conv Q1 on the card.

Marked ``gpu``: each test skips inside its body when no CUDA device is
present, so every pytest worker collects the same tests. Run on a card with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu_serving.py

- A bundle exported and loaded on the card equals the live ``Detector``
  there array for array (32^3, width 1.0, bfloat16, batch sizes 1 and 2, 3
  rows), with K1-K3 launching inside the loaded programs: K1 once a
  program call, and with ``use_pallas`` + ``use_pallas_tail`` K2 once and
  K3 once (the cluster kernel) a call.
- Q1 equals its plain version on every conv kind of the model: the int32
  sums exactly (the kernel's raw mode) and the epilogue bit for bit.
- The int8 program's detections on the card equal the plain int8 program's
  on the CPU: equal counts and labels, boxes and scores within 1e-5 (the
  card's softmax and decode round apart from the CPU's).
"""

import numpy as np
import pytest
import torch

from mslesions3d_tpu_torch import quant
from mslesions3d_tpu_torch.kernels.depthwise import fused_depthwise_bn_relu_cuda
from mslesions3d_tpu_torch.kernels.nms import greedy_nms_cuda
from mslesions3d_tpu_torch.kernels.qconv import (qconv_cuda, qconv_reference, qconv_s32,
                                                  qconv_s32_cuda)
from mslesions3d_tpu_torch.kernels.tail import fused_tail_cuda
from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.serving import (DetectionProgram, Detector, ServingDetector,
                                           export_detector, save_bundle)

pytestmark = pytest.mark.gpu

INPUT = (32, 32, 32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("flags", [{}, {"use_pallas": True, "use_pallas_tail": True}],
                         ids=["default", "both"])
def test_bundle_on_the_card_equals_the_live_detector(flags, tmp_path):
    _need_card()
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=INPUT, width_mult=1.0,
                             dtype="bfloat16", min_score=0.0, top_k=10, **flags)
    state_dict = SSD3D(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    exports, manifest = export_detector(cfg, state_dict, (1, 2))
    assert manifest["platforms"] == ["cuda"]
    det = ServingDetector(save_bundle(tmp_path / "m.mslx", exports, manifest))
    live = Detector(cfg, state_dict, batch_sizes=(1, 2))
    x = np.random.default_rng(0).normal(size=(3, *INPUT, 1)).astype(np.float32)
    want = live.predict(x)
    counters = (greedy_nms_cuda, fused_depthwise_bn_relu_cuda, fused_tail_cuda)
    before = [c.launches for c in counters]
    got = det.predict(x)  # two program calls: 2 + 1 rows
    torch.cuda.synchronize()
    fused = 2 if flags else 0
    assert [c.launches - b for c, b in zip(counters, before)] == [2, fused, fused]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(want["count"].min()) > 0


CONVS = {  # the model's conv kinds: input shape, weight shape, strides, groups
    "stem": ((2, 12, 12, 12, 1), (3, 3, 3, 1, 32), (2, 2, 2), 1),
    "depthwise_s1": ((2, 6, 6, 6, 32), (3, 3, 3, 1, 32), (1, 1, 1), 32),
    "depthwise_s2": ((2, 7, 6, 5, 32), (3, 3, 3, 1, 32), (2, 2, 2), 32),
    "pointwise": ((2, 6, 6, 6, 32), (1, 1, 1, 32, 64), (1, 1, 1), 1),
    "pointwise_odd": ((2, 5, 5, 5, 6), (1, 1, 1, 6, 10), (1, 1, 1), 1),
    "head": ((2, 6, 6, 6, 16), (3, 3, 3, 16, 12), (1, 1, 1), 1),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_q1_equals_its_plain_version(name):
    _need_card()
    shape, wshape, strides, groups = CONVS[name]
    rng = np.random.default_rng(sorted(CONVS).index(name))
    q = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, wshape).astype(np.int8))
    acc = qconv_s32_cuda(q.cuda(), wq.cuda(), strides, groups)
    assert acc.dtype == torch.int32
    assert torch.equal(acc.cpu(), qconv_s32(q, wq, strides, groups))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, wshape[-1]).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=wshape[-1]).astype(np.float32))
    for relu in (False, True):
        got = qconv_cuda(q.cuda(), wq.cuda(), scale.cuda(), bias.cuda(), strides, groups, relu)
        want = qconv_reference(q, wq, scale, bias, strides, groups, relu)
        assert torch.equal(got.cpu(), want), relu


def test_int8_program_on_the_card_equals_the_cpu():
    _need_card()
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=INPUT, width_mult=0.25,
                             min_score=0.0, top_k=10)
    state_dict = SSD3D(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    x = np.random.default_rng(1).normal(size=(2, *INPUT, 1)).astype(np.float32)
    qm = quant.quantize_ssd3d(cfg, state_dict, x, device="cpu")
    before = qconv_cuda.launches
    out = {}
    for device in ("cpu", "cuda"):
        program = DetectionProgram(quant.QuantizedSSD3D(qm), model_priors(cfg),
                                   n_classes=cfg.n_classes, min_score=cfg.min_score,
                                   max_overlap=cfg.max_overlap, top_k=cfg.top_k).to(device)
        with torch.inference_mode():
            out[device] = {k: v.cpu() for k, v in program(torch.from_numpy(x).to(device)).items()}
    # one launch a backbone conv, one a feature layer's fused loc + cls heads
    assert qconv_cuda.launches - before == len(qm["layers"]) + len(qm["feature_layers"])
    for k in ("count", "labels"):
        assert torch.equal(out["cuda"][k], out["cpu"][k]), k
    for k in ("boxes", "scores"):
        torch.testing.assert_close(out["cuda"][k], out["cpu"][k], rtol=0, atol=1e-5)
    assert int(out["cpu"]["count"].min()) > 0
