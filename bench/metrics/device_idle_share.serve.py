"""The device's idle share of the traced run's profiled stretch, %."""
from bench.metrics._idle import idle


def read(ctx):
    return idle(ctx)
