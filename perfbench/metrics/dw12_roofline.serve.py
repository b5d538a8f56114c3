"""cuDNN's depthwise convs of blocks 1 and 2 (stride 2, no fused kernel):
their frozen byte bound (input read once, output written once, weights)
over the device time of the kernels launched under the ``perfbench.dw12``
range, which the traffic module opens at each of those blocks and closes at its
first BatchNorm."""

from perfbench.metrics import _counts as counts


def read(ctx):
    if ctx.trace is None:
        return None
    device_s, spans = ctx.trace.under("perfbench.dw12")
    if spans == 0:
        return None
    m, b = ctx.run.cfg, int(ctx.run.cell.params["batch"])
    layers = sorted(int(k) for k in m["aspect_ratios"])
    dims, cin, per_call = list(m["input_size"]), m["input_channels"], 0.0
    for i, (_, cout, stride) in enumerate(counts.layer_plan(layers, m["width_mult"])):
        if i in (1, 2):
            per_call += counts.dw_conv_bound((b, cin, *dims), stride, 2)[0]
        dims = [(d - 1) // stride + 1 for d in dims]
        cin = cout
    return counts.share(per_call * spans / 2, device_s)
