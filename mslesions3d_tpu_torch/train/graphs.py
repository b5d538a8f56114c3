"""The whole-epoch train program on the card: one train step as a CUDA graph.

The JAX package runs a non-metric epoch as one device program (``lax.scan``
over the epoch's batches in ``make_gathered_train_epoch``), so that no host
work separates its steps. On the card the counterpart is a CUDA graph:
:class:`GraphedEpoch` captures one gathered train step (the row gather from
the device cache, the patch and augmentation draws, the forward, the loss,
autograd's backward, the optimizer, the EMA, the non-finite select) and the
write-back of the new state into the step's static input state, then
replays it once per row of the epoch's index matrix. A replay is one launch
from the host where a stepped step is thousands.

* The capture is made after warm-up steps on a side stream (cuDNN's and
  autograd's lazy set-up allocates and waits, which a capture refuses), run
  on the static state with the generator's state saved before them and
  restored after, so the caller sees none of their draws.
* The caller's generator is registered with the graph
  (``CUDAGraph.register_generator_state``): each replay reads its seed and
  offset as they stand and advances the offset by what one step draws, so
  replay i draws what stepped step i draws, and a re-seed between calls is
  seen.
* The batch's rows come from a static (B,) index buffer, filled from row i
  of the index matrix before replay i; the step's metrics land in a static
  vector, copied into row i of the epoch's metrics after it. So a step is
  three host calls.
* The capture is kept for its key (the state's structure and optimizer,
  the data's tensors, B, the generator, the cuDNN and TF32 flags in force)
  and made again only when it changes. The static state is the graph's:
  the caller's state is copied into it at the start of a call and the
  result cloned out at the end (one copy of params, optimizer state, BN
  statistics and EMA each way), so no state handed out aliases a buffer a
  later call writes. The copy in runs under the span ``msl.epoch.state_in``,
  the clone out and the metrics' split under ``msl.epoch.state_out``
  (``utils.profiling.span``); the replays run none.
* The capture marks the step's phases (``utils.profiling.marking``): the
  timing events that the step's ``phases`` record (the train step's
  ``msl.step.forward``, ``.backward`` and ``.update``, a ConvNet block's
  ``msl.convnet.conv`` and ``.norm_act``) and a pair around the whole
  captured body (``msl.epoch.replay``) are event-record nodes of the graph,
  which every replay records again at no launch. While a profiler records,
  a call first reads the previous call's last replay where its last event
  is done (``Event.query``, no wait), and adds each phase's elapsed device
  ms to ``marked_ms`` and one to ``sampled``; :meth:`GraphedEpoch.phase_ms`
  gives the ms a sampled step. With no profiler recording a call reads
  nothing.

Nothing here falls back to stepping: a capture or replay that fails raises.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..parallel.mesh import tree_rebuild, tree_tensors
from ..utils.profiling import marking, phases, span
from .state import TrainState

# the per-step metrics the epoch keeps: the keys of the JAX package's scan body
EPOCH_METRICS = ("total_loss", "conf_loss", "loc_loss", "grad_norm", "nonfinite_streak")
WARMUP_STEPS = 2


def _cloned(state: TrainState) -> TrainState:
    return tree_rebuild(state, map(torch.clone, tree_tensors(state)))


def stack_metrics(metrics: dict) -> torch.Tensor:
    """A step's kept metrics as one float32 vector (the streak is exact)."""
    return torch.stack([metrics[k].float() for k in EPOCH_METRICS])


def split_metrics(rows: torch.Tensor) -> dict:
    """(n, 5) stacked rows -> the epoch's (n,) metrics by name."""
    out = {k: rows[:, j] for j, k in enumerate(EPOCH_METRICS)}
    out["nonfinite_streak"] = out["nonfinite_streak"].to(torch.int32)
    return out


def _key(state: TrainState, data: dict, batch: int) -> tuple:
    """What a capture holds fixed: the state's structure and optimizer, the
    data's tensors (by address), B, and the flags that choose cuDNN's and
    cuBLAS's kernels (a graph keeps the kernels of its capture)."""
    tensors = tree_tensors(state)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    return (state.tx, state.ema_params is not None, tuple(state.params), tuple(state.batch_stats),
            tuple((t.shape, t.dtype, t.stride(), t.device) for t in tensors),
            tuple((k, v.data_ptr(), v.shape, v.dtype, v.stride()) for k, v in data.items()),
            batch, flags)


@dataclasses.dataclass
class _Capture:
    key: tuple
    generator: torch.Generator | None
    graph: torch.cuda.CUDAGraph
    state: TrainState  # the static input state, written back by every replay
    idx: torch.Tensor  # (B,) int64, the rows replay i gathers
    metrics: torch.Tensor  # (5,) float32, replay i's kept metrics
    marks: list  # (phase, start event, end event) of the step, recorded by every replay
    replayed: bool = False  # the events hold a replay's times, or will once it ends


class GraphedEpoch:
    """fn(state, data, idx_matrix, generator) -> (state, metrics) on the card,
    replaying ``step`` (a gathered train step, fn(state, data, idx,
    generator)) captured once. ``captures`` counts the captures made and
    ``capture_s`` holds the seconds of the last, warm-up included;
    ``marked_ms`` sums each marked phase's device ms over the ``sampled``
    replays (read while a profiler records)."""

    def __init__(self, step):
        self.step = step
        self.captured: _Capture | None = None
        self.captures = 0
        self.capture_s = 0.0
        self.marked_ms: dict = {}
        self.sampled = 0

    def phase_ms(self) -> dict:
        """{phase: device ms a sampled replay}; empty before any sample."""
        return {k: v / self.sampled for k, v in self.marked_ms.items()} if self.sampled else {}

    def _sample(self, cap: _Capture) -> None:
        """Adds the last replay's phases to the counters, where it has ended."""
        if not (cap.replayed and cap.marks and cap.marks[-1][2].query()):
            return
        for name, start, end in cap.marks:
            self.marked_ms[name] = self.marked_ms.get(name, 0.0) + start.elapsed_time(end)
        self.sampled += 1

    def __call__(self, state: TrainState, data: dict, idx_matrix, generator=None):
        device = state.device
        idx_matrix = torch.as_tensor(idx_matrix, device=device)
        n, batch = idx_matrix.shape
        key = _key(state, data, batch)
        cap = self.captured
        if cap is None or cap.key != key or cap.generator is not generator:
            self.captured = None  # the old graph's pool goes before the new one is made
            cap = self.captured = self._capture(state, data, batch, generator, key)
        elif torch._C._autograd._profiler_enabled():
            self._sample(cap)
        with span("msl.epoch.state_in"):
            torch._foreach_copy_(tree_tensors(cap.state), tree_tensors(state))
        rows = torch.empty((n, len(EPOCH_METRICS)), dtype=torch.float32, device=device)
        for i in range(n):
            cap.idx.copy_(idx_matrix[i])
            cap.graph.replay()
            rows[i].copy_(cap.metrics)
        cap.replayed = cap.replayed or n > 0
        with span("msl.epoch.state_out"):
            return _cloned(cap.state), split_metrics(rows)

    def _capture(self, state, data, batch, generator, key) -> _Capture:
        t0 = time.perf_counter()
        device = state.device
        static = _cloned(state)
        idx = torch.zeros(batch, dtype=torch.int64, device=device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            if generator is not None:
                graph.register_generator_state(generator)
                saved = generator.get_state()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self.step(static, data, idx, generator)
            torch.cuda.current_stream(device).wait_stream(side)
            if generator is not None:
                generator.set_state(saved)
            marks = []
            with torch.cuda.graph(graph), marking(marks), phases("msl.epoch.replay"):
                new, m = self.step(static, data, idx, generator)
                torch._foreach_copy_(tree_tensors(static), tree_tensors(new))
                metrics = stack_metrics(m)
            torch.cuda.synchronize(device)
        self.captures += 1
        self.capture_s = time.perf_counter() - t0
        return _Capture(key, generator, graph, static, idx, metrics, marks)
