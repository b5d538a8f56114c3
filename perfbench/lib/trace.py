"""Reading a torch.profiler trace of the measured window.

The window is the span of one ``record_function`` range (:data:`WINDOW`)
that the harness opens around it; device time is the union of every device
interval (kernels, copies, sets) that falls inside it, so idle time before
the first kernel and after the last counts as idle. A layer's device time
is read under the CPU range that launched it (a registered op of the
program, or a range the benchmark opens), never by kernel name.
"""

from __future__ import annotations

import bisect

from torch.autograd import DeviceType

WINDOW = "perfbench.window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


class Trace:
    """The events of one profiled window, read once."""

    def __init__(self, prof):
        self.events = list(prof.events())
        spans = [e for e in self.events if e.name == WINDOW and e.device_type == DeviceType.CPU]
        if not spans:
            raise RuntimeError("the profiler recorded no window range")
        self.start, self.end = spans[0].time_range.start, spans[0].time_range.end
        self.device = [e for e in self.events if e.device_type == DeviceType.CUDA
                       and e.time_range.end > self.start and e.time_range.start < self.end
                       and e.name != WINDOW and not e.name.startswith("perfbench.")]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the window, sorted (us)."""
        spans = sorted((max(e.time_range.start, self.start), min(e.time_range.end, self.end))
                       for e in self.device)
        merged = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[[device operation, seconds]] of the ``top`` longest in total."""
        by_name: dict = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], us / 1e6] for name, us in rows]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host ran, seconds]]: the window's idle time on the device,
        by the innermost host range running where each gap began, largest first."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for s, t in busy for x in (s, t)] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in self.events
                       if e.device_type == DeviceType.CPU and e.name != WINDOW
                       and e.time_range.end > self.start and e.time_range.start < self.end),
                      key=lambda r: r[0])
        starts = [r[0] for r in host]
        by_name: dict = {}
        for s, t in gaps:
            i = bisect.bisect_right(starts, s)
            name = "host (no range)"
            for j in range(i - 1, max(i - 400, -1), -1):
                if host[j][1] > s:
                    name = host[j][2]
                    break
            by_name[name] = by_name.get(name, 0.0) + (t - s)
        rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], us / 1e6] for name, us in rows]

    def under(self, name: str) -> tuple[float, int]:
        """(device seconds, count) of the kernels launched under every host
        range called ``name`` in the window."""
        total, count = 0.0, 0
        for e in self.events:
            if e.name == name and e.device_type == DeviceType.CPU \
                    and self.start <= e.time_range.start < self.end:
                total += e.device_time_total
                count += 1
        return total / 1e6, count

    def copy_s(self, kind: str) -> float:
        """Device seconds of the copies of ``kind`` ("HtoD", "DtoH", "DtoD")."""
        return sum(e.time_range.end - e.time_range.start for e in self.device
                   if "Memcpy" in e.name and kind in e.name) / 1e6

    def launches(self) -> int:
        """Host calls that put work on the device (kernel, graph, copy and set launches)."""
        return sum(1 for e in self.events if e.device_type == DeviceType.CPU
                   and e.name in LAUNCH_CALLS and self.start <= e.time_range.start < self.end)
