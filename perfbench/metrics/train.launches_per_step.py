"""Host calls that put work on the card (kernel, graph, copy and set
launches: the profiler's CUDA runtime rows) over the steps of the traced
window."""


def read(ctx):
    if ctx.trace is None or not ctx.run.steps:
        return None
    return ctx.trace.launches() / ctx.run.steps
