"""Kernels 3, 6 and 7 at the conv corner (``conv_fused_engine``,
``conv_fused_engine_bwd_x``, ``conv_fused_engine_bwd_w``) over a train
step: their least time over their profiled device time, %."""
from bench.metrics._roofline import share


def read(ctx):
    return share(ctx, ("conv_fused_engine", "conv_fused_engine_bwd_x", "conv_fused_engine_bwd_w"))
