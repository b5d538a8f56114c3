"""K1 (``msl::greedy_nms``): the frozen NMS bound of the candidates each
call's rows hold, over the device time of the kernels launched under the
op, a call at a time averaged over the traced window's calls."""

from perfbench.metrics import _counts as counts


def read(ctx):
    if ctx.trace is None:
        return None
    device_s, launches = ctx.trace.under("msl::greedy_nms")
    if launches == 0:
        return None
    k, rows = ctx.run.nms_last_valid()
    bounds = [counts.nms_bound(len(r), k, r)[0] for r in rows]
    return counts.share(launches * sum(bounds) / len(bounds), device_s)
