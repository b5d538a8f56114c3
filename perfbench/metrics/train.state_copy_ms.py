"""Device milliseconds a step of the work launched under the program's
``msl.epoch.state_in`` and ``msl.epoch.state_out`` spans (the state copied
into the epoch graph's static state and cloned out), over the steps of the
traced window."""

from perfbench.metrics import _spans


def read(ctx):
    if ctx.trace is None or not ctx.run.steps:
        return None
    parts = [ctx.trace.under(name) for name in _spans.STATE_COPIES]
    if not any(count for _, count in parts):
        return None
    return 1e3 * sum(device_s for device_s, _ in parts) / ctx.run.steps
