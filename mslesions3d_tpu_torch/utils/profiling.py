"""Profiling and timing on the card (counterpart of
``mslesions3d_tpu/utils/profiling.py``).

Usage:
    from mslesions3d_tpu_torch.utils.profiling import time_fn, trace
    ms = time_fn(fn, args)                     # steady-state ms per call
    with trace("build/trace"):                 # torch.profiler trace for TensorBoard
        fn(*args)

``time_fn``, ``trace`` and ``StepTimer`` are the JAX package's. The rest
reads the device's own clock from a ``torch.profiler`` trace:
:func:`device_ms` (the kernels one call launches, in total and by kernel
function), :func:`device_ms_rounds`, :func:`device_busy_ms` (the union of
the kernels' intervals) and :func:`profile_calls` (busy time, idle share,
launches and the top kernels of a few calls). Those take a ``log``
callable for what they report, ``print`` by default.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def block(tree):
    """Waits for the card when any tensor of ``tree`` (a tensor, or a
    dict, list or tuple of them) lies on it; returns ``tree``."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return tree


def time_fn(fn, args=(), kwargs=None, iters: int = 20, warmup: int = 3) -> float:
    """Steady-state wall-clock ms per call: a first call (the kernels build
    and the caches warm), ``warmup`` more, then ``iters`` timed ones, each
    phase waited for on the card."""
    kwargs = kwargs or {}
    out = block(fn(*args, **kwargs))
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    block(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    block(out)
    return (time.perf_counter() - t0) / iters * 1e3


@contextlib.contextmanager
def trace(logdir):
    """A ``torch.profiler`` trace of the block (the CPU and, with a card,
    its kernels), written to ``logdir`` for TensorBoard's profiler plugin."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield


class StepTimer:
    """Lightweight per-step timing for training loops.

    Records wall seconds between successive .tick() calls; .summary() gives
    mean/p50/max over the recorded window.
    """

    def __init__(self, window: int = 200):
        self.window = window
        self.times: list[float] = []
        self._last: float | None = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            "step_time_mean_s": sum(ts) / len(ts),
            "step_time_p50_s": ts[len(ts) // 2],
            "step_time_max_s": ts[-1],
        }


def kernel_name(key: str) -> str:
    """A profiler row's kernel function, without namespace and arguments."""
    return key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]


def device_ms(fn, iters: int, log=print, tries: int = 4) -> tuple[float, dict]:
    """Mean device ms per call of the kernels fn launches, in total and by
    kernel function: their durations in a torch.profiler trace, host gaps
    excluded. The profiler can lose kernel records, a number a trace that
    grows with what the process and the card ran before (on an H100: none
    in a fresh process, 2-4 after rank processes shared the card, 21 late
    in ``chip_smoke.py``), and sometimes all of them. So each kernel function
    counts as its mean duration over the records kept times its launches
    per call (its records over the calls traced, rounded), the records lost
    are logged, and a trace that kept no record or lost more than a quarter
    of its launches is taken again with twice the calls, up to ``tries``
    traces; one that still keeps none raises."""
    calls = iters
    for attempt in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        split, lost, launches = {}, 0, 0
        for e in rows:
            name = kernel_name(e.key)
            per_call = max(1, round(e.count / calls))
            launches += per_call * calls
            lost += per_call * calls - e.count
            split[name] = (split.get(name, 0.0)
                           + e.self_device_time_total / e.count * per_call / 1e3)
        if rows and 4 * lost <= launches:
            break
        if attempt + 1 < tries:
            log(f"the profiler kept {sum(e.count for e in rows)} kernel records of {calls} "
                f"calls; tracing once more with {2 * calls} calls")
            calls *= 2
    if not rows:
        raise RuntimeError(f"the profiler saw no kernel on the card in {tries} traces")
    if lost:
        log(f"the profiler lost {lost} kernel records of {calls} calls; each kernel function "
            "is timed by the mean of the records it kept")
    return sum(split.values()), split


def device_ms_rounds(fn, iters: int, rounds: int = 3, log=print) -> tuple[list, dict]:
    """device_ms in ``rounds`` traces: (the rounds' ms per call, sorted; the
    median round's ms per call by kernel function)."""
    results = sorted((device_ms(fn, iters, log) for _ in range(rounds)), key=lambda r: r[0])
    return [total for total, _ in results], results[rounds // 2][1]


def device_busy_ms(prof) -> tuple[float, float]:
    """(busy, span) in ms of the profiled kernels: busy is the union of
    their intervals, so kernels that overlap count once. A trace with no
    kernel raises."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler saw no kernel on the card")
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return busy / 1e3, (max(end for _, end in spans) - spans[0][0]) / 1e3


def profile_calls(label, what, fn, card, calls=3, top=12, log=print) -> dict:
    """torch.profiler breakdown of ``calls`` calls of fn() (``what``) after a warm one:
    the device's busy time and idle share, launches per call and the ``top``
    kernels by device time (all of them, ms a call, in ``by_kernel``)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms, span_ms = device_busy_ms(prof)
    launches = sum(e.count for e in rows) // calls
    cudnn_dw = sum(e.count for e in rows if "convolveNd" in e.key) // calls
    conv = sum(e.count for e in rows if "conv" in e.key.lower()) // calls
    idle = 1 - busy_ms / span_ms
    log(f"profile [{label}] of {calls} {what}: device busy {busy_ms:.3f} ms (union of kernel "
        f"intervals) of a {span_ms:.3f} ms span from the first kernel's start to the last one's "
        f"end, idle share {idle:.3f}; host window {window_ms:.3f} ms; {launches} kernel launches "
        f"per call, {cudnn_dw} of them cuDNN's convolveNd kernels (grouped convs: forward, "
        f"dgrad, wgrad), {conv} with 'conv' in the name [{card}]")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3 / calls:9.3f} ms/call  {e.count // calls:4d} "
            f"launches/call  {e.key[:90]}")
    by_kernel = {}
    for e in rows:
        by_kernel[kernel_name(e.key)] = (by_kernel.get(kernel_name(e.key), 0.0)
                                         + e.self_device_time_total / 1e3 / calls)
    return {"busy_ms": busy_ms / calls, "idle_share": idle, "launches": launches,
            "window_ms": window_ms / calls, "by_kernel": by_kernel}
