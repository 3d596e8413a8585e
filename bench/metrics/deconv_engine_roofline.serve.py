"""Kernel 3 at the deconv corner (``fused_engine``) over the served
generates: its least time over its profiled device time, %."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, ("fused_engine",))
