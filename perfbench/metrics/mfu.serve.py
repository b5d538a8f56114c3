"""The whole forward's share of the card's bf16 peak: the forward's FLOPs
(``_counts.forward_count``) times the volumes scored in the traced window,
over the window's seconds times 989 TFLOP/s."""

from perfbench.metrics import _counts as counts


def read(ctx):
    if ctx.trace is None:
        return None
    m = ctx.run.cfg
    flops, _ = counts.forward_count(m["input_size"], m["input_channels"], m["width_mult"],
                                    m["boxes_per_location"], m["n_classes"])
    return 100.0 * flops * ctx.out["attempted"] / (ctx.trace.window_s
                                                   * counts.PEAK_BF16_TENSOR_FLOPS)
