"""Kernels 3, 6 and 7 at the deconv corner (``fused_engine``,
``fused_engine_bwd_x``, ``fused_engine_bwd_w``) over a train step: their
least time over their profiled device time, %."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, ("fused_engine", "fused_engine_bwd_x", "fused_engine_bwd_w"))
