"""Host calls that put work on the card (``perfbench.lib.trace.LAUNCH_CALLS``)
starting inside the program's ``msl.epoch.state_in`` and
``msl.epoch.state_out`` spans, over the steps of the traced window."""

from perfbench.metrics import _spans


def read(ctx):
    if ctx.trace is None or not ctx.run.steps \
            or not _spans.intervals(ctx.trace, *_spans.STATE_COPIES):
        return None
    return _spans.launches_in(ctx.trace, *_spans.STATE_COPIES) / ctx.run.steps
