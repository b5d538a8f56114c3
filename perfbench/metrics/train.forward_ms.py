"""Device ms a step of the train step's ``msl.step.forward`` phase, timed by
the events the program captures into the epoch's CUDA graph (``_marks``)."""

from perfbench.metrics import _marks


def read(ctx):
    return _marks.phase_ms(ctx, "msl.step.forward")
