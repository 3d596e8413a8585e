"""The served generates' share of the card's peak, %: direct-algorithm
FLOPs of the images returned over the window's unprofiled part (padding
rows do not count)."""
from bench.metrics._mfu import mfu


def read(ctx):
    return mfu(ctx, ctx["flops_per_image"] * ctx["images_free"])
