"""Median of the engine's own stamps t_dispatch - t_submit, ms, over the
requests completed in the window's unprofiled part."""
from bench.yardstick.stats import percentile


def read(ctx):
    waits = ctx["queue_wait_ms"]
    return percentile(waits, 50) if waits else None
