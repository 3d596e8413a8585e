"""Model FLOPs of the direct algorithm (``yardstick.flops``) done in the
window after the profiled stretch, over its seconds, as a share of the
card's fp32-accurate product rate (dense TF32 / 3), %."""
from bench.yardstick import work


def mfu(ctx, model_flops: float):
    if ctx["seconds_free"] <= 0 or model_flops <= 0:
        return None
    return 100.0 * model_flops / ctx["seconds_free"] / work.peaks_for(ctx["device_name"])[2]
