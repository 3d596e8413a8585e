"""The train step's share of the card's peak, %: direct-algorithm FLOPs of
the steps completed over the window's unprofiled part."""
from bench.metrics._mfu import mfu


def read(ctx):
    return mfu(ctx, ctx["flops_per_step"] * ctx["steps_free"])
