"""Host milliseconds a predict call inside the program's ``msl.route.upload``
spans (the host cast of the float32 volumes and the pageable copy to the
card), over the calls of the traced window."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.host_ms_a_call(ctx, "msl.route.upload")
