"""The program's phase markers inside the epoch's CUDA graph.

``train.graphs.GraphedEpoch`` captures timing events at the train step's
phase boundaries (``msl.step.forward``, ``.backward``, ``.update``) and at
each ConvNet block's (``msl.convnet.conv``, ``.norm_act``); while a
profiler records it reads a replay's elapsed times where the replay has
ended and keeps their sums, which ``phase_ms()`` gives as device ms a
sampled step. A program without the accessor (or a run that sampled no
step, or has no trace) reads nothing."""

from __future__ import annotations


def phase_ms(ctx, name: str):
    """Device ms a sampled step in the marked phase ``name``, or None."""
    graphed = getattr(getattr(ctx.run, "fn", None), "graphed", None)
    accessor = getattr(graphed, "phase_ms", None)
    if ctx.trace is None or accessor is None:
        return None
    return accessor().get(name)
