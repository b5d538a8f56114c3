"""Host milliseconds a predict call inside the program's ``msl.route.fetch``
spans (the host waiting for the card, then the copy of the detections
back), over the calls of the traced window."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_a_call(ctx, "msl.route.fetch")
