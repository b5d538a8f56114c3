"""Host milliseconds a predict call inside the program's ``msl.detect``
spans (the host launching the forward and the detection, any wait inside
them included), over the calls of the traced window."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_a_call(ctx, "msl.detect")
