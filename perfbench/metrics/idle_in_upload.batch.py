"""The share of the traced window in which the card was idle while the host
was inside the program's ``msl.route.upload`` spans: the idle time that
``route``'s cast and copy leave, of ``idle_share.batch``."""

from perfbench.metrics import _spans


def read(ctx):
    if ctx.trace is None or not _spans.intervals(ctx.trace, "msl.route.upload"):
        return None
    return _spans.idle_share_in(ctx.trace, "msl.route.upload")
