"""K2 (``msl::fused_depthwise_bn_relu``): the frozen byte bound of each
launch's input (the stride-1 blocks before the fused tail whose channels are
a multiple of 128) over the device time under the op."""

from perfbench.metrics import _counts as counts


def read(ctx):
    if ctx.trace is None:
        return None
    device_s, launches = ctx.trace.under("msl::fused_depthwise_bn_relu")
    if launches == 0:
        return None
    m, b = ctx.run.cfg, int(ctx.run.cell.params["batch"])
    layers = sorted(int(k) for k in m["aspect_ratios"])
    dims, cin, shapes = list(m["input_size"]), m["input_channels"], []
    for i, (_, cout, stride) in enumerate(counts.layer_plan(layers, m["width_mult"])):
        if 0 < i <= min(layers) and stride == 1 and cin % 128 == 0:
            shapes.append((b, cin, *dims))
        dims = [(d - 1) // stride + 1 for d in dims]
        cin = cout
    per_call = sum(counts.dw_bound(s, 2)[0] for s in shapes)
    return counts.share(per_call * launches / max(len(shapes), 1), device_s)
