#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit; TF32 off for convs and matmuls.
2. build: nvcc builds every CUDA kernel of the served path from ``csrc/``.
3. K1 (greedy 3D NMS) against its plain torch version on the card, with
   exact equality of the keep masks, on synthetic cases and on the real
   candidate sets of the 96^3 model.
4. the slice: a ``Detector`` at the bench's headline configuration (96^3,
   bf16, full width, random weights from a seed) serves requests of 1, 3
   and 8 volumes through a ``RequestBatcher``; the NMS kernel's launch count
   must rise; the kernel and plain NMS give identical detections on the
   same (locs, scores); the fp32 forward on the card agrees with the CPU's.
5. times on the card: K1 and the plain version at N = 8 and 128 rows of
   K = 1000 candidates, K1's bound, the detect path's parts, end-to-end
   volumes/s at batch 1, 8 and 32, and a torch.profiler breakdown of the
   device time by kernel with the device's idle share.
6. one JSON line listing every ported kernel, then the card line, then the
   result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mslesions3d_tpu_torch.kernels.build import build
from mslesions3d_tpu_torch.kernels.nms import greedy_nms, greedy_nms_cuda
from mslesions3d_tpu_torch.models.ssd3d import SSD3DConfig
from mslesions3d_tpu_torch.ops.nms import detect_objects, nms_candidates, select_detections
from mslesions3d_tpu_torch.serving import Detector, RequestBatcher

# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores, and device memory bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations per candidate pair in csrc/nms.cu: per axis min, max,
# sub, clamp (12); two products; add, sub and div for the union and IoU;
# the compare.
NMS_OPS_PER_PAIR = 18
HEADLINE = dict(n_classes=2, input_channels=1, input_size=(96, 96, 96), dtype="bfloat16",
                min_score=0.5, max_overlap=0.5, top_k=100)


class SmokeFailure(RuntimeError):
    pass


def check(cond, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def log(*parts) -> None:
    print("#", *parts, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- NMS cases
def clustered_case(rng, n=4, k=200):
    """K=200, not a multiple of 32 or 128; random validity."""
    centers = rng.uniform(0.2, 0.8, size=(n, 25, 3))
    idx = rng.integers(0, 25, size=(n, k))
    lo = np.clip(np.take_along_axis(centers, idx[..., None], 1)
                 + rng.normal(0, 0.03, (n, k, 3)) - 0.04, 0, 1)
    hi = np.clip(lo + rng.uniform(0.04, 0.12, (n, k, 3)), 0, 1)
    return np.concatenate([lo, hi], -1), rng.uniform(size=(n, k)) > 0.15


def prefix_case(rng, n=3, k=384):
    """Validity a prefix of 90, 200 and all 384 candidates."""
    lo = rng.uniform(0, 0.7, (n, k, 3))
    hi = np.clip(lo + rng.uniform(0.05, 0.3, (n, k, 3)), 0, 1)
    valid = np.zeros((n, k), bool)
    valid[0, :90], valid[1, :200], valid[2, :] = True, True, True
    return np.concatenate([lo, hi], -1), valid


def random_case(rng, n=128, k=1000):
    """Clustered boxes with a random valid prefix per row, some rows empty."""
    boxes, _ = clustered_case(rng, n, k)
    valid = np.arange(k)[None, :] < rng.integers(0, k + 1, size=(n, 1))
    valid[0], valid[1:4] = False, True  # an empty row and full rows
    return boxes, valid


def near_threshold_case():
    """Unit cubes offset by the float32 neighbours of 1/3: IoU straddles 0.5."""
    third = np.float32(1) / np.float32(3)
    shifts = [third]
    for _ in range(6):
        shifts = [np.nextafter(shifts[0], np.float32(0)), *shifts,
                  np.nextafter(shifts[-1], np.float32(1))]
    rows = []
    for j, s in enumerate(shifts):
        scale = np.float32([0.125, 0.25, 0.1, 0.3][j % 4])
        a = np.float32([0.1, 0.2, 0.05, 0.1 + scale, 0.2 + scale, 0.05 + scale])
        b = a.copy()
        b[j % 3] += s * scale
        b[j % 3 + 3] += s * scale
        empty = np.float32([0.1, 0.2, 0.05, 0.1, 0.2, 0.05])
        rows.append(np.stack([a, b, empty, empty]))
    boxes = np.stack(rows)
    return boxes, np.ones(boxes.shape[:2], bool)


def compare_nms(name, boxes, valid, max_overlap=0.5) -> int:
    """Run K1 and the plain version on the same card tensors; returns mismatches."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device="cuda").contiguous()
    valid = torch.as_tensor(valid, dtype=torch.bool, device="cuda").contiguous()
    keep = greedy_nms_cuda(boxes, valid, max_overlap)
    torch.cuda.synchronize()
    plain = greedy_nms(boxes, valid, max_overlap)
    mismatches = int((keep != plain).sum())
    log(f"K1 vs plain [{name}]: N={boxes.shape[0]} K={boxes.shape[1]} "
        f"valid share {float(valid.float().mean()):.3f} kept {int(keep.sum())} "
        f"mismatches {mismatches}")
    check(mismatches == 0, f"K1 disagrees with the plain NMS on {name}")
    return mismatches


def nms_bound(valid: torch.Tensor):
    """(bound ms, bound_by, operations, bytes) of greedy NMS on these candidates.

    The work depends on the data: only pairs below each row's last valid
    candidate are counted, as the kernel skips the rest.
    """
    n, k = valid.shape
    pos = torch.arange(1, k + 1, device=valid.device)
    last = torch.where(valid, pos, 0).amax(dim=1).double()
    ops = float((last * (last - 1) / 2).sum()) * NMS_OPS_PER_PAIR
    nbytes = n * k * (6 * 4 + 1) + n * k  # boxes and valid in, keep out
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), ops, nbytes


def device_busy_ms(prof) -> tuple[float, float]:
    """(busy, span) in ms of the profiled kernels: busy is the union of
    their intervals, so kernels that overlap count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    check(spans, "the profiler saw no kernel on the card")
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return busy / 1e3, (max(end for _, end in spans) - spans[0][0]) / 1e3


# ---------------------------------------------------------------- phases
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    log("TF32 is off for cuDNN convolutions and for matmuls")

    # 2. build
    t0 = time.perf_counter()
    path, build_log = build("nms")
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s; nvcc -Xptxas -v:")
    for line in build_log.splitlines():
        if "ptxas info" in line or "spill" in line:
            log("  " + line.strip())

    # 3. K1 against its plain version on synthetic cases
    rng = np.random.default_rng(0)
    mismatches = 0
    mismatches += compare_nms("clustered K=200", *clustered_case(rng))
    mismatches += compare_nms("prefix 90/200/384", *prefix_case(rng))
    mismatches += compare_nms("near threshold", *near_threshold_case())
    mismatches += compare_nms("random N=128 K=1000", *random_case(rng))

    # 4. the slice at the headline configuration
    config = SSD3DConfig.create(**HEADLINE)
    detector = Detector(config, device="cuda", seed=0, batch_sizes=(1, 8, 32))
    n_params = sum(p.numel() for p in detector.model.parameters())
    log(f"Detector: 96^3 bf16 MobileNet SSD3D width 1.0, {n_params:,} parameters, "
        f"{detector.priors.shape[0]} priors, K = {min(10 * config.top_k, detector.priors.shape[0])}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def volumes(b):
        return torch.randn((b, *config.input_size, 1), generator=gen, device="cuda")

    cand = {}
    with torch.inference_mode():
        for b in (8, 128):
            locs, scores = detector.model(volumes(b).to(config.compute_dtype))
            cand[b] = nms_candidates(locs, scores, detector.priors, n_classes=config.n_classes,
                                     min_score=config.min_score, top_k=config.top_k)
            boxes, _, valid = cand[b]
            mismatches += compare_nms(f"96^3 model candidates, batch {b}",
                                      boxes.contiguous(), valid)

    host_rng = np.random.default_rng(1)
    requests = [host_rng.standard_normal((n, *config.input_size, 1), dtype=np.float32)
                for n in (1, 3, 8)]
    batcher = RequestBatcher(detector.predict, max_rows=32)
    try:
        greedy_nms_cuda.launches = 0
        with ThreadPoolExecutor(max_workers=len(requests)) as ex:
            served = list(ex.map(batcher.submit, requests))
        main_path_launches = greedy_nms_cuda.launches
    finally:
        batcher.close()
    log(f"served requests of {[r.shape[0] for r in requests]} volumes in "
        f"{batcher.device_calls} device calls; K1 launches {main_path_launches}")
    check(main_path_launches > 0, "the served path did not launch the NMS kernel")
    for req, det in zip(requests, served):
        n = req.shape[0]
        check(det["boxes"].shape == (n, config.top_k, 6), f"boxes shape {det['boxes'].shape}")
        check(det["labels"].shape == det["scores"].shape == (n, config.top_k), "labels/scores shape")
        check(det["count"].shape == (n,), "count shape")
        check(all(np.isfinite(det[k]).all() for k in ("boxes", "scores")), "non-finite output")
        check(((det["count"] >= 0) & (det["count"] <= config.top_k)).all(), "count out of range")
    counts = np.concatenate([d["count"] for d in served])
    log(f"detections per volume: {counts.tolist()}")
    check(counts.max() > 0, "no volume has a detection")

    with torch.inference_mode():
        x = volumes(8).to(config.compute_dtype)
        locs, scores = detector.model(x)
        kw = dict(n_classes=config.n_classes, top_k=config.top_k)
        det = detect_objects(locs, scores, detector.priors, min_score=config.min_score,
                             max_overlap=config.max_overlap, **kw)
        boxes, cscores, valid = nms_candidates(locs, scores, detector.priors,
                                               min_score=config.min_score, **kw)
        plain = select_detections(boxes, cscores, greedy_nms(boxes, valid, config.max_overlap), **kw)
        torch.cuda.synchronize()
    for key in det:
        check(torch.equal(det[key], plain[key]), f"detect_objects with K1 != plain NMS in {key}")
    log("detect_objects with K1 == detect_objects with the plain NMS (all four outputs, batch 8)")

    small = SSD3DConfig.create(n_classes=2, input_channels=1, input_size=(32, 32, 32))
    gpu32 = Detector(small, device="cuda", seed=3).model
    cpu32 = Detector(small, device="cpu", seed=3).model
    xs = torch.from_numpy(host_rng.standard_normal((2, 32, 32, 32, 1), dtype=np.float32))
    with torch.inference_mode():
        outs_gpu = [t.cpu() for t in gpu32(xs.cuda())]
        outs_cpu = cpu32(xs)
    for name, a, b in zip(("locs", "scores"), outs_gpu, outs_cpu):
        err = float((a - b).abs().max())
        log(f"fp32 32^3 forward, card vs CPU: {name} max abs diff {err:.3e}")
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-5), f"fp32 forward {name}: card != CPU")

    # 5. times on the card
    times = {}
    for b in (8, 128):
        boxes, _, valid = cand[b]
        boxes = boxes.contiguous()
        bound_ms, bound_by, ops, nbytes = nms_bound(valid)
        k_ms = cuda_ms(lambda: greedy_nms_cuda(boxes, valid, 0.5), iters=50)
        p_ms = cuda_ms(lambda: greedy_nms(boxes, valid, 0.5), iters=5, warmup=1)
        share = float(valid.float().mean())
        times[b] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"K1 time N={valid.shape[0]} K={valid.shape[1]} valid share {share:.3f}: "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
            f"({ops:.3e} fp32 ops at 67 TFLOP/s; {nbytes:,} bytes at 3.35 TB/s) [{card}]")
    log("no PyTorch call computes 3D greedy NMS: library_ms is null")

    with torch.inference_mode():
        for b in (1, 32):
            x = volumes(b).to(config.compute_dtype)
            fwd_ms = cuda_ms(lambda: detector.model(x), iters=10)
            locs, scores = detector.model(x)
            det_ms = cuda_ms(lambda: detect_objects(
                locs, scores, detector.priors, min_score=config.min_score,
                max_overlap=config.max_overlap, **kw), iters=10)
            all_ms = cuda_ms(lambda: detector.detect(x), iters=10)
            log(f"batch {b} on the card: forward {fwd_ms:.3f} ms, detect_objects {det_ms:.3f} ms, "
                f"Detector.detect {all_ms:.3f} ms [{card}]")

    for b in (1, 8, 32):
        imgs = host_rng.standard_normal((b, *config.input_size, 1), dtype=np.float32)
        for _ in range(2):
            detector.predict(imgs)
        iters = {1: 20, 8: 10, 32: 5}[b]
        t0 = time.perf_counter()
        for _ in range(iters):
            detector.predict(imgs)
        dt = time.perf_counter() - t0
        log(f"Detector.predict batch {b}: {b * iters / dt:.1f} volumes/s "
            f"({dt / iters * 1e3:.2f} ms per call, numpy in and out) [{card}]")

    # profiled last: the profiler may leave tracing overhead behind it
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                detector.detect(x)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    kernel_rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms, span_ms = device_busy_ms(prof)
    log(f"profile of 3 Detector.detect calls at batch 32: device busy {busy_ms:.3f} ms "
        f"(union of kernel intervals) of a {span_ms:.3f} ms span from the first kernel's "
        f"start to the last one's end, idle share {1 - busy_ms / span_ms:.3f}; host window "
        f"{window_ms:.3f} ms [{card}]")
    for e in sorted(kernel_rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3 / 3:9.3f} ms/call  {e.count // 3:4d} launches/call  "
            f"{e.key[:90]}")

    # 6. kernels line, card line, result line
    kernels = [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "mslesions3d_tpu_torch/csrc/nms.cu",
        "replaces": "mslesions3d_tpu/kernels/nms.py:134",
        "launches": main_path_launches,
        "max_abs_err": 0.0 if mismatches == 0 else 1.0,
        "mismatches": mismatches,
        "ms": times[8]["ms"],
        "plain_ms": times[8]["plain_ms"],
        "bound_ms": times[8]["bound_ms"],
        "bound_by": times[8]["bound_by"],
        "library_ms": None,
        "shape": "N=8 K=1000: the served batch of 8, candidates of the 96^3 model",
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
