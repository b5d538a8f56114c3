"""The port's own spans and counters, and the benchmark's readers of them, on the CPU.

* ``utils.profiling.span`` is one shared null context while no profiler
  records, and a range that is not a user annotation while one does (a user
  annotation is mirrored on the device timeline, where a reader of the
  device's events would count it as busy time);
* ``serving.route`` opens ``msl.route`` around a call and, a chunk at a
  time, ``msl.route.upload``, ``msl.detect`` and ``msl.route.fetch``, nested
  in it, with ``msl.detect_objects`` inside ``msl.detect``; its counters
  ``program_calls`` and ``padded_rows`` count the chunks and the padding,
  and lose no count to threads routing at once; on the CPU a chunk of any
  host dtype takes one ``.to`` and nothing is staged (``staged_uploads``
  and ``staged_bytes`` stay put);
* an exported program holds no profiler node, and its bundle answers as
  the live detector does;
* the epoch program's CPU path opens one ``msl.epoch`` a call, and the
  train step it runs (the step the card captures into a CUDA graph) opens
  its phases alone, ``msl.step.forward``, ``.backward`` and ``.update``
  (``tests/test_torch_port_step_markers.py``);
* ``RequestBatcher``'s ``requests``, ``rows`` and ``queue_wait_s`` add up
  over coalesced submits;
* the benchmark's readers of the spans (``perfbench/metrics``), on a
  hand-made trace: host ms a call, device ms, the idle share inside a
  span and the launches made from one; each reads nothing (None) from a
  trace without the program's spans.
"""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mslesions3d_tpu_torch.models.ssd3d import SSD3D, SSD3DConfig, model_priors
from mslesions3d_tpu_torch.serving import (
    Detector,
    RequestBatcher,
    ServingDetector,
    export_detector,
    route,
    save_bundle,
)
from mslesions3d_tpu_torch.train import create_train_state, make_gathered_train_epoch
from mslesions3d_tpu_torch.train.steps import make_gathered_train_step
from mslesions3d_tpu_torch.utils.profiling import span
from perfbench.lib import harness
from perfbench.lib.trace import WINDOW, Trace

SMALL = dict(n_classes=2, input_channels=1, input_size=(16, 16, 16), width_mult=0.25,
             min_score=0.0, top_k=4)
ROUTE = ("msl.route.upload", "msl.detect", "msl.detect_objects", "msl.route.fetch")


def _msl_events(prof) -> list:
    return [e for e in prof.events() if e.name.startswith("msl.")]


def _named(events, name) -> list:
    return sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert span("msl.a") is span("msl.b")
    with span("msl.a") as inside:
        assert inside is None


def test_spans_are_not_user_annotations():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("msl.outer"):
            with span("msl.inner"):
                torch.ones(8).cumsum(0)
    events = _msl_events(prof)
    assert sorted(e.name for e in events) == ["msl.inner", "msl.outer"]
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in events)
    (inner,), (outer,) = _named(events, "msl.inner"), _named(events, "msl.outer")
    assert _inside(inner, outer)


@pytest.mark.parametrize("rows, batch_sizes, calls, padded",
                         [(9, (1, 8), 2, 0), (7, (8,), 1, 1)])
def test_route_spans_and_counters(rows, batch_sizes, calls, padded):
    detector = Detector(SSD3DConfig.create(**SMALL), device="cpu", batch_sizes=batch_sizes)
    images = np.random.default_rng(rows).normal(size=(rows, 16, 16, 16, 1)).astype(np.float32)
    before = (route.program_calls, route.padded_rows)
    staged = (route.staged_uploads, route.staged_bytes)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = detector.predict(images)
    assert out["boxes"].shape == (rows, 4, 6)
    assert (route.program_calls - before[0], route.padded_rows - before[1]) == (calls, padded)
    assert (route.staged_uploads, route.staged_bytes) == staged
    events = _msl_events(prof)
    (whole,) = _named(events, "msl.route")
    for name in ROUTE:
        spans = _named(events, name)
        assert len(spans) == calls, name
        assert all(_inside(s, whole) for s in spans), name
    chunks = zip(*(_named(events, name) for name in ROUTE))
    for upload, call, detect_objects, fetch in chunks:  # in order, one chunk after another
        assert upload.time_range.end <= call.time_range.start
        assert _inside(detect_objects, call)
        assert call.time_range.end <= fetch.time_range.start
    # the same call unprofiled answers the same and counts the same
    again = detector.predict(images)
    for k in out:
        np.testing.assert_array_equal(again[k], out[k])
    assert route.program_calls - before[0] == 2 * calls


def test_route_counters_hold_under_threads():
    """Threads routing at once (more than the cores, switching every
    microsecond) lose no count: each route of 3 rows on the size 2 is two
    program calls and one padded row."""
    threads, routes = 16, 100
    images = np.ones((3, 4), np.float32)
    before = (route.program_calls, route.padded_rows)
    staged = (route.staged_uploads, route.staged_bytes)

    def work():
        for _ in range(routes):
            route(images, (2,), "cpu", torch.float32, lambda x: {"s": x.sum(1)})

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            for future in [ex.submit(work) for _ in range(threads)]:
                future.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert (route.program_calls - before[0], route.padded_rows - before[1]) == (
        2 * threads * routes, threads * routes)
    assert (route.staged_uploads, route.staged_bytes) == staged


@pytest.mark.parametrize("host, served", [(np.float32, torch.bfloat16),
                                           (np.float32, torch.float32),
                                           (np.float64, torch.bfloat16),
                                           (np.float16, torch.float32),
                                           (np.int16, torch.bfloat16)])
def test_route_on_the_cpu_takes_one_to_of_any_host_dtype(host, served):
    """On the CPU a chunk goes in one ``.to(cpu, dtype)`` of the caller's
    rows, the padded rows zero, whatever the host dtype; nothing is staged."""
    images = (np.random.default_rng(5).normal(size=(3, 2, 5)) * 100).astype(host)
    seen = []

    def call(x):
        seen.append(x.clone())
        return {"s": x.float().sum((1, 2))}

    staged = (route.staged_uploads, route.staged_bytes)
    out = route(images, (4,), "cpu", served, call)
    (x,) = seen
    assert x.dtype == served and x.shape == (4, 2, 5)
    assert torch.equal(x[:3], torch.from_numpy(images).to(served)) and not x[3].any()
    np.testing.assert_array_equal(out["s"], x[:3].float().sum((1, 2)).numpy())
    assert (route.staged_uploads, route.staged_bytes) == staged


def test_exported_program_holds_no_profiler_node(tmp_path):
    cfg = SSD3DConfig.create(**SMALL)
    state_dict = create_train_state(cfg, seed=2, device="cpu").state_dict()
    exports, manifest = export_detector(cfg, state_dict, (1, 2), platforms=["cpu"])
    path = save_bundle(tmp_path / "m.mslx", exports, manifest)
    served = ServingDetector(path, device="cpu")
    for b, fn in served._fns.items():
        targets = [str(n.target) for n in fn.graph.nodes if n.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t or "record" in t], b
    images = np.random.default_rng(5).normal(size=(3, 16, 16, 16, 1)).astype(np.float32)
    live = Detector(cfg, state_dict, device="cpu", batch_sizes=(1, 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = served.predict(images)
    want = live.predict(images)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    names = [e.name for e in _msl_events(prof)]
    assert names.count("msl.detect") == 2 and "msl.detect_objects" not in names


def test_cpu_epoch_opens_one_span_a_call():
    cfg = SSD3DConfig.create(**SMALL, lr=1e-3, threshold=(0.1, 0.2))
    model, priors = SSD3D(cfg), model_priors(cfg)
    rng = np.random.default_rng(0)
    data = {"image": torch.from_numpy(rng.normal(size=(4, 16, 16, 16, 1)).astype(np.float32)),
            "boxes": torch.tensor([[[0.2, 0.2, 0.2, 0.6, 0.6, 0.6]]] * 4),
            "labels": torch.ones((4, 1), dtype=torch.int32),
            "box_mask": torch.ones((4, 1), dtype=torch.bool)}
    idx = torch.tensor([[0, 1], [2, 3]])
    epoch = make_gathered_train_epoch(cfg, model, priors)
    step = make_gathered_train_step(cfg, model, priors)
    state = create_train_state(cfg, seed=1, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, m = epoch(state, data, idx)
        state, _ = epoch(state, data, idx)
    assert m["total_loss"].shape == (2,)
    events = sorted(_msl_events(prof), key=lambda e: (e.time_range.start, -e.time_range.end))
    phases = ["msl.step.forward", "msl.step.backward", "msl.step.update"]
    assert [e.name for e in events] == (["msl.epoch"] + phases * 2) * 2
    calls = _named(events, "msl.epoch")
    assert all(any(_inside(e, call) for call in calls) for e in events)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, data, idx[0])
    # the step a graph captures opens its phases alone, no span of the epoch
    assert [e.name for e in _msl_events(prof)] == phases


def test_request_batcher_counters_add_up():
    gate, entered = threading.Event(), threading.Event()
    calls = []

    def predict(images):
        calls.append(images.shape[0])
        entered.set()
        assert gate.wait(10)
        return {"count": np.arange(images.shape[0])}

    batcher = RequestBatcher(predict, max_rows=64)
    sizes = (1, 2, 3, 1)
    results = {}

    def submit(i):
        results[i] = batcher.submit(np.zeros((sizes[i], 2), np.float32))

    threads = [threading.Thread(target=submit, args=(0,))]
    threads[0].start()
    try:
        assert entered.wait(10)  # the first call is in flight; the others queue behind it
        for i in range(1, len(sizes)):
            threads.append(threading.Thread(target=submit, args=(i,)))
            threads[-1].start()
        deadline = time.monotonic() + 10
        while batcher._q.qsize() < len(sizes) - 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        held = 0.3
        time.sleep(held)
        gate.set()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        gate.set()
        batcher.close()
    assert calls == [1, 6]  # the three queued requests coalesced into one call
    assert (batcher.requests, batcher.rows, batcher.device_calls) == (4, 7, 2)
    assert [len(results[i]["count"]) for i in range(len(sizes))] == list(sizes)
    assert batcher.queue_wait_s >= held * (len(sizes) - 1)
    assert batcher.queue_wait_s < 30


# hand-made traces (microseconds): a window of 1000 us

def _ev(name, start, end, device=False, device_time=0.0):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_time_total=device_time)


def _trace(events):
    return Trace(SimpleNamespace(events=lambda: [_ev(WINDOW, 0, 1000), *events]))


def _read(metric, trace, steps=0):
    path = harness.reader_path(metric)
    module = harness.load_module(path, "test_reader_" + path.stem.replace(".", "_"))
    return module.read(SimpleNamespace(trace=trace, run=SimpleNamespace(steps=steps)))


SERVE_DEVICE = [_ev("kernel", 100, 250, True), _ev("Memcpy HtoD", 400, 600, True)]
SERVE_HOST = [_ev("perfbench.call", 0, 500), _ev("perfbench.call", 500, 1000),
              _ev("cudaLaunchKernel", 50, 52), _ev("cudaMemcpyAsync", 520, 530)]
SERVE_SPANS = [_ev("msl.route.upload", 0, 200), _ev("msl.route.upload", 500, 650),
               _ev("msl.detect", 200, 300), _ev("msl.detect", 650, 700),
               _ev("msl.detect_objects", 250, 290, device_time=40.0),
               _ev("msl.detect_objects", 660, 690, device_time=20.0),
               _ev("msl.route.fetch", 300, 500), _ev("msl.route.fetch", 700, 1000)]
# device busy [100, 250] and [400, 600]: idle [0, 100], [250, 400], [600, 1000]
SERVE_READINGS = {"route.upload_ms.batch": 0.175,  # (200 + 150) us over 2 calls
                  "route.detect_ms.batch": 0.075,
                  "route.fetch_ms.batch": 0.25,
                  "detect_objects_ms.batch": 0.03,  # (40 + 20) us of device time over 2 calls
                  "idle_in_upload.batch": 0.15}  # [0, 100] and [600, 650] of 1000 us

TRAIN_DEVICE = [_ev("graph kernel", 150, 650, True), _ev("Memcpy DtoD", 720, 760, True)]
TRAIN_HOST = [_ev("perfbench.step", 0, 820), _ev("cudaLaunchKernel", 10, 11),
              _ev("cudaLaunchKernel", 20, 21), _ev("cudaLaunchKernel", 30, 31),
              _ev("cudaGraphLaunch", 200, 210), _ev("cudaMemcpyAsync", 710, 711),
              _ev("cudaMemcpyAsync", 720, 721), _ev("cudaLaunchKernel", 850, 851),
              _ev("aten::copy_", 715, 716)]
TRAIN_SPANS = [_ev("msl.epoch", 0, 800), _ev("msl.epoch.state_in", 0, 100, device_time=30.0),
               _ev("msl.epoch.state_out", 700, 800, device_time=50.0)]
# device idle [0, 150], [650, 720], [760, 1000]; inside the epoch 150 + 70 + 40 us
TRAIN_READINGS = {"train.state_copy_ms": 0.04,  # (30 + 50) us over 2 steps
                  "train.state_copy_launches_per_step": 2.5,  # 3 in, 2 out, over 2 steps
                  "idle_in_epoch.train": 0.26}


@pytest.mark.parametrize("readings, events, steps", [
    (SERVE_READINGS, SERVE_DEVICE + SERVE_HOST + SERVE_SPANS, 0),
    (TRAIN_READINGS, TRAIN_DEVICE + TRAIN_HOST + TRAIN_SPANS, 2),
], ids=["serve", "train"])
def test_span_readers_on_a_hand_made_trace(readings, events, steps):
    trace = _trace(events)
    for metric, want in readings.items():
        assert _read(metric, trace, steps) == pytest.approx(want), metric


@pytest.mark.parametrize("metric", [*SERVE_READINGS, *TRAIN_READINGS])
def test_span_readers_read_nothing_without_the_spans(metric):
    assert _read(metric, None, 2) is None
    # a program that opens no span of its own (the benchmark's ranges alone)
    trace = _trace(SERVE_DEVICE + SERVE_HOST + TRAIN_DEVICE + TRAIN_HOST)
    assert _read(metric, trace, 2) is None
