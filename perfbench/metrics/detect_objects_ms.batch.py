"""Device milliseconds a predict call of the kernels launched under the
program's ``msl.detect_objects`` spans (decode, score filter, K1, top-k),
over the calls of the traced window."""


def read(ctx):
    if ctx.trace is None:
        return None
    device_s, spans = ctx.trace.under("msl.detect_objects")
    _, calls = ctx.trace.under("perfbench.call")
    return None if spans == 0 or calls == 0 else 1e3 * device_s / calls
