"""Host milliseconds a predict call inside the program's ``msl.route.upload``
spans (the host cast of the float32 volumes into a pinned buffer of the
served type, and the one copy of it to the card that the span queues), over
the calls of the traced window."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_a_call(ctx, "msl.route.upload")
