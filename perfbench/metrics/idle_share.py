"""The card's idle share: the part of the traced window in which no kernel,
copy or set ran on it (the union of the device intervals)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 1.0 - ctx.trace.busy_s() / ctx.trace.window_s
