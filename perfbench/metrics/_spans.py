"""The program's own spans in a traced window: interval arithmetic.

A span is a host range the program opens (``utils.profiling.span``:
``msl.route.upload``, ``msl.epoch``, ...), recorded by the profiler on the
clock it gives the device's records, so host time in a span, the device's
idle time while the host was in it, and the launches made from it are read
by intersecting intervals (microseconds). The functions take the window's
``perfbench.lib.trace.Trace``; ``host_ms_a_call`` takes a reader's context.
"""

from __future__ import annotations

import bisect

from torch.autograd import DeviceType

from perfbench.lib.trace import LAUNCH_CALLS

# the epoch program's state copied into its graph, and cloned out
STATE_COPIES = ("msl.epoch.state_in", "msl.epoch.state_out")


def _merged(spans) -> list:
    merged = []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def intervals(trace, *names) -> list:
    """The union of the host ranges called any of ``names``, clipped to the
    window, sorted."""
    return _merged((max(e.time_range.start, trace.start), min(e.time_range.end, trace.end))
                   for e in trace.events
                   if e.name in names and e.device_type == DeviceType.CPU
                   and e.time_range.end > trace.start and e.time_range.start < trace.end)


def idle_intervals(trace) -> list:
    """The window less the union of the device's intervals, sorted."""
    edges = [trace.start] + [x for s, t in trace.busy_intervals() for x in (s, t)] + [trace.end]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def overlap_us(a: list, b: list) -> float:
    """The length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(trace, *names) -> float:
    """The share of the window in which the device was idle and the host
    inside one of ``names``."""
    return overlap_us(idle_intervals(trace), intervals(trace, *names)) / (trace.end - trace.start)


def launches_in(trace, *names) -> int:
    """Host calls that put work on the device (``LAUNCH_CALLS``) starting
    inside one of ``names``."""
    spans = intervals(trace, *names)
    starts = [s for s, _ in spans]
    count = 0
    for e in trace.events:
        if e.name in LAUNCH_CALLS and e.device_type == DeviceType.CPU:
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start < spans[i][1]:
                count += 1
    return count


def host_ms_a_call(ctx, name: str):
    """Host milliseconds inside ``name`` over the window's ``perfbench.call``
    ranges; None without a trace, a call or the span."""
    if ctx.trace is None:
        return None
    _, calls = ctx.trace.under("perfbench.call")
    spans = intervals(ctx.trace, name)
    if calls == 0 or not spans:
        return None
    return sum(t - s for s, t in spans) / 1e3 / calls
