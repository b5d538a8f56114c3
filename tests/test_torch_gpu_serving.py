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
- ``route``'s staged upload (the host casts into a pinned buffer, one
  copy to the card) gives the program the input ``.to(cuda, dtype)`` gave,
  bit for bit, NaN payloads too, padded rows zero, at 1 to 33 volumes of
  96^3 and from float64, float16 and int16 arrays; ``Detector.predict``
  answers as on that input; each program call counts one staged upload and
  its host bytes; back-to-back routes whose caller overwrites its array as
  soon as a route returns, and four threads routing at once, each get their
  own input.
"""

import sys
from concurrent.futures import ThreadPoolExecutor

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
                                           export_detector, route, save_bundle)

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


HEADLINE = (96, 96, 96)
STAGED = ("program_calls", "staged_uploads", "staged_bytes")


def _counts() -> list:
    return [getattr(route, k) for k in STAGED]


def _chunks(n, batch_sizes) -> list:
    """route's chunks of n rows: (start, rows, batch size)."""
    out, start = [], 0
    while start < n:
        fits = [b for b in batch_sizes if b <= n - start]
        b = max(fits) if fits else min(batch_sizes)
        out.append((start, min(b, n - start), b))
        start += min(b, n - start)
    return out


def _host_upload(rows, b, dtype) -> torch.Tensor:
    """The upload before staging: zero rows padded on the host, then one
    ``.to(cuda, dtype)`` (the host casts, then a pageable copy)."""
    pad = b - rows.shape[0]
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, *rows.shape[1:]), rows.dtype)])
    return torch.from_numpy(np.ascontiguousarray(rows)).to("cuda", dtype)


def _hard_floats(n, seed) -> np.ndarray:
    """n float32 volumes of 96^3: normals, any bit pattern in a quarter of
    each, and at its start ties at bfloat16's rounding boundary (even and
    odd), subnormals, +-0, +-inf, NaNs of several payloads and signs, and
    values about bfloat16's largest."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *HEADLINE, 1)).astype(np.float32)
    bits = x.view(np.uint32).reshape(n, -1)
    q = bits.shape[1] // 4
    bits[:, -q:] = rng.integers(0, 2 ** 32, size=(n, q), dtype=np.uint32)
    upper = rng.integers(0, 2 ** 16, size=4096, dtype=np.uint32) << 16
    special = np.concatenate([
        upper | 0x8000, upper | 0x7FFF, upper | 0x8001,  # ties, and an ulp either side
        np.arange(1, 4097, dtype=np.uint32), np.arange(1, 4097, dtype=np.uint32) | 0x80000000,
        np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                  0x7F800001, 0xFFFFFFFF, 0x7FBFFFFF], np.uint32),
        np.arange(0x7F7F0000, 0x7F800000, 16, dtype=np.uint32),  # bf16's max, and past it
        np.arange(0xFF7F0000, 0xFF800000, 16, dtype=np.uint32),
    ])
    bits[:, :special.size] = special
    return x


def _assert_same_input(got, want):
    """Bit for bit, NaN payloads too."""
    assert got.shape == want.shape and got.dtype == want.dtype
    int_type = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[want.dtype]
    assert torch.equal(got.view(int_type), want.view(int_type))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n", [1, 5, 8, 32, 33])
def test_staged_upload_gives_the_host_cast_bit_for_bit(n, dtype):
    _need_card()
    images = _hard_floats(n, n)
    seen = []

    def call(x):
        seen.append(x.clone())
        return {"rows": torch.zeros(x.shape[0], device=x.device)}

    before = _counts()
    out = route(images, (8, 32), "cuda", dtype, call)
    assert out["rows"].shape == (n,)
    chunks = _chunks(n, (8, 32))
    assert len(seen) == len(chunks)
    for x, (start, rows, b) in zip(seen, chunks):
        _assert_same_input(x, _host_upload(images[start: start + rows], b, dtype))
        assert not x[rows:].any()
    assert [a - b for a, b in zip(_counts(), before)] == [len(chunks), len(chunks),
                                                          images.nbytes]


@pytest.mark.parametrize("host", [np.float64, np.float16, np.int16])
def test_staged_upload_casts_any_host_dtype(host):
    _need_card()
    images = (np.random.default_rng(11).normal(size=(5, *HEADLINE, 1)) * 300).astype(host)
    seen = []

    def call(x):
        seen.append(x.clone())
        return {"rows": torch.zeros(x.shape[0], device=x.device)}

    before = _counts()
    route(images, (8,), "cuda", torch.bfloat16, call)
    (x,) = seen
    _assert_same_input(x, _host_upload(images, 8, torch.bfloat16))
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, images.nbytes]


def test_detector_answers_as_on_the_host_cast_input():
    _need_card()
    cfg = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=HEADLINE,
                             width_mult=1.0, dtype="bfloat16", min_score=0.0, top_k=100,
                             use_pallas=True, use_pallas_tail=True)
    det = Detector(cfg, seed=3, batch_sizes=(1, 8, 32))
    x = np.random.default_rng(32).normal(size=(32, *HEADLINE, 1)).astype(np.float32)
    want = {k: v.cpu().numpy() for k, v in det.detect(_host_upload(x, 32, torch.bfloat16)).items()}
    before = _counts()
    got = det.predict(x)
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, x.nbytes]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(want["count"].min()) > 0


def _echo(x):
    return {"x": x.float()}


def _host_cast(images, dtype) -> np.ndarray:
    """The input the host cast gave, as float32, in an array of its own."""
    return torch.from_numpy(images).to(dtype).float().numpy().copy()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_back_to_back_routes_keep_their_own_input(dtype):
    """The caller overwrites its array as soon as a route returns: each
    route still gets its own rows, so the pinned buffer was not refilled
    while copied."""
    _need_card()
    rng = np.random.default_rng(7)
    images = rng.normal(size=(33, *HEADLINE, 1)).astype(np.float32)
    for _ in range(6):
        want = _host_cast(images, dtype)
        got = route(images, (8, 32), "cuda", dtype, _echo)["x"]
        images[...] = rng.normal(size=images.shape)
        np.testing.assert_array_equal(got, want)


def test_threads_routing_at_once_each_get_their_own_input():
    _need_card()
    threads, routes = 4, 3

    def work(seed):
        rng = np.random.default_rng(100 + seed)
        nbytes = 0
        for _ in range(routes):
            images = rng.normal(size=(9, *HEADLINE, 1)).astype(np.float32)
            got = route(images, (1, 8), "cuda", torch.bfloat16, _echo)["x"]
            np.testing.assert_array_equal(got, _host_cast(images, torch.bfloat16))
            nbytes += images.nbytes
        return nbytes

    before = _counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            nbytes = [f.result(timeout=300) for f in [ex.submit(work, i) for i in range(threads)]]
    finally:
        sys.setswitchinterval(interval)
    calls = threads * routes * 2  # 9 rows on (1, 8): a chunk of 8 and one of 1
    assert [a - b for a, b in zip(_counts(), before)] == [calls, calls, sum(nbytes)]
