"""Device ms a step in the weight-gradient kernel of the depthwise convs and
the stem (``msl.train.dw_wgrad``, summed over its launches: a chunk of
samples each), timed by the events the program captures into the epoch's
CUDA graph (``_marks``). A program without the marker reads nothing."""

from perfbench.metrics import _marks


def read(ctx):
    return _marks.phase_ms(ctx, "msl.train.dw_wgrad")
