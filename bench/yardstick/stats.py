"""Order statistics of the benchmark's samples."""
from __future__ import annotations

import math


def percentile(xs: list[float], p: float) -> float:
    """Linearly interpolated percentile (p in [0, 100]) of a non-empty list
    (the arithmetic of the port's ``serve/metrics.py::percentile`` at the
    benchmark's first version).  A failed request enters as ``inf``, which
    misses any limit: a percentile that reaches it is ``inf``."""
    if not xs:
        raise ValueError("percentile of empty list")
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    if math.isinf(s[hi]) and frac > 0 or math.isinf(s[lo]):
        return math.inf
    return s[lo] * (1 - frac) + s[hi] * frac
