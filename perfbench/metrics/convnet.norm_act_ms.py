"""Device ms a step of the ConvNet tower's forward InstanceNorm, dropout and
PReLU (``msl.convnet.norm_act``, summed over the blocks), timed by the
events the program captures into the epoch's CUDA graph (``_marks``)."""

from perfbench.metrics import _marks


def read(ctx):
    return _marks.phase_ms(ctx, "msl.convnet.norm_act")
