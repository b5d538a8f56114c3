"""Profiling and timing on the card (counterpart of
``mslesions3d_tpu/utils/profiling.py``).

Usage:
    from mslesions3d_tpu_torch.utils.profiling import time_fn, trace
    ms = time_fn(fn, args)                     # steady-state ms per call
    with trace("build/trace"):                 # torch.profiler trace for TensorBoard
        fn(*args)

``time_fn`` and ``trace`` are the JAX package's. :func:`span` opens the
program's own named ranges (``msl.route``, ``msl.epoch``, ...) while a
profiler records. :func:`phases` marks consecutive phases of device work
(the train step's, a ConvNet block's) where a CUDA graph replays them:
timing events captured into the graph under :func:`marking`, spans on the
eager path. The rest reads the device's own clock from a
``torch.profiler`` trace:
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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range called ``name`` while a profiler records, else a
    shared null context (a check of ~0.15 us on the host).

    The range is ``torch._C._profiler._RecordFunctionFast``, the function-scope
    range torch's inductor opens around its kernels, not
    ``torch.profiler.record_function``: that one is a user annotation, which
    the profiler mirrors on the device timeline as a range spanning the
    range's kernels, so a reader of the device's events would count it as
    busy time. The profiler's ``device_time_total`` of the range still sums
    the kernels launched inside it. Open spans in eager host code only: a
    CUDA graph's replay runs none of them, and under ``torch.export`` (with
    no profiler recording) the null context leaves no node in the program.
    """
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


# the list a capture under way records its phases into (``marking``), else None
_MARKS = None


@contextlib.contextmanager
def marking(marks: list):
    """Inside the block (a CUDA graph's capture) :func:`phases` records timing
    events on the current stream, captured as event-record nodes that every
    replay records again, and appends (name, start event, end event) to
    ``marks`` as each phase ends."""
    global _MARKS
    saved, _MARKS = _MARKS, marks
    try:
        yield
    finally:
        _MARKS = saved


def _recorded_event() -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True, external=True)
    event.record()
    return event


class _Phases:
    """Consecutive phases, the first opened on entry, each ``next(name)``
    ending the phase open and opening ``name``, the last ended on exit.
    Under ``marking`` a boundary is one event, the end of a phase and the
    start of the next; else each phase is a ``span``."""

    def __init__(self, name: str, marks: list | None):
        self.name, self.marks = name, marks

    def __enter__(self):
        if self.marks is None:
            self._open_span()
        else:
            self.start = _recorded_event()
        return self

    def next(self, name: str) -> None:
        self._end()
        self.name = name
        if self.marks is None:
            self._open_span()

    def __exit__(self, *exc):
        self._end()

    def _open_span(self):
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()

    def _end(self):
        if self.marks is None:
            self.range.__exit__(None, None, None)
        else:
            end = _recorded_event()
            self.marks.append((self.name, self.start, end))
            self.start = end


class _NoPhases:
    def __enter__(self):
        return self

    def next(self, name: str) -> None:
        pass

    def __exit__(self, *exc):
        pass


_NO_PHASES = _NoPhases()


def phases(first: str):
    """``with phases(first) as p: ...; p.next(name); ...``: consecutive
    phases of device work, timed where a CUDA graph replays them and seen in
    an eager trace.

    While a capture marks (:func:`marking`) the boundaries are timing events
    captured into the graph (no launch: a replay records them with its
    kernels, and the reader takes their elapsed times once the replay has
    ended); while a profiler records, each phase is a :func:`span`; else
    the shared null object, so an eager step with no profiler records no
    event and opens no range."""
    if _MARKS is not None:
        return _Phases(first, _MARKS)
    if torch._C._autograd._profiler_enabled():
        return _Phases(first, None)
    return _NO_PHASES


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
