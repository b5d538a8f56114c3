"""Device milliseconds of host-to-card copies a predict call (the profiler's
memcpy rows), over the calls of the traced window."""


def read(ctx):
    if ctx.trace is None:
        return None
    _, calls = ctx.trace.under("perfbench.call")
    return None if calls == 0 else 1e3 * ctx.trace.copy_s("HtoD") / calls
