"""A training step's share of the card's float32 peak: 3 x the forward's
FLOPs (``_counts.forward_count``; forward, input gradients and weight
gradients) times the volumes stepped in the traced window, over the
window's seconds times 67 TFLOP/s (IEEE float32, no tensor cores)."""

from perfbench.metrics import _counts as counts


def read(ctx):
    if ctx.trace is None:
        return None
    m = ctx.run.cfg
    flops, _ = counts.forward_count(m["input_size"], m["input_channels"], m["width_mult"],
                                    m["boxes_per_location"], m["n_classes"], elem_bytes=4)
    return 100.0 * 3 * flops * ctx.out["attempted"] / (ctx.trace.window_s
                                                       * counts.PEAK_FP32_FLOPS)
