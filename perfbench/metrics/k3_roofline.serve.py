"""K3 (``msl::fused_tail``): the frozen bound of the tail (every block past
the first feature layer, on its input, the deeper feature maps written) over
the device time under the op."""

from perfbench.metrics import _counts as counts


def read(ctx):
    if ctx.trace is None:
        return None
    device_s, launches = ctx.trace.under("msl::fused_tail")
    if launches == 0:
        return None
    m, b = ctx.run.cfg, int(ctx.run.cell.params["batch"])
    layers = sorted(int(k) for k in m["aspect_ratios"])
    plan = counts.layer_plan(layers, m["width_mult"])
    dims, cin = list(m["input_size"]), m["input_channels"]
    for _, cout, stride in plan[:min(layers) + 1]:
        dims = [(d - 1) // stride + 1 for d in dims]
        cin = cout
    first = min(layers) + 1
    blocks, c = [], cin
    for _, cout, stride in plan[first:]:
        blocks.append((c, cout, stride))
        c = cout
    emit = [i - first for i in layers if i >= first]
    per_call, _ = counts.tail_bound((b, cin, *dims), 2, blocks, emit)
    return counts.share(per_call * launches, device_s)
