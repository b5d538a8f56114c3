"""A ConvNet training step's share of the card's float32 peak: 3 x the
forward's FLOPs (``_counts_convnet.forward_flops``, tower and heads; forward,
input gradients and weight gradients) times the volumes stepped in the
traced window, over the window's seconds times 67 TFLOP/s (IEEE float32, no
tensor cores)."""

from perfbench.metrics import _counts as counts
from perfbench.metrics import _counts_convnet as convnet


def read(ctx):
    if ctx.trace is None:
        return None
    flops = sum(convnet.forward_flops(ctx.run.cfg))
    return 100.0 * 3 * flops * ctx.out["attempted"] / (ctx.trace.window_s
                                                       * counts.PEAK_FP32_FLOPS)
