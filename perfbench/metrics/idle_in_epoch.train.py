"""The share of the traced window in which the card was idle while the host
was inside the program's ``msl.epoch`` spans (an epoch call); the rest of
``idle_share.train`` falls between calls, in the caller."""

from perfbench.metrics import _spans


def read(ctx):
    if ctx.trace is None or not _spans.intervals(ctx.trace, "msl.epoch"):
        return None
    return _spans.idle_share_in(ctx.trace, "msl.epoch")
