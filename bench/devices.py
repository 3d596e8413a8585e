"""The device a run used, as its result line names it."""
from __future__ import annotations

import torch


def name(dev) -> str:
    d = torch.device(dev)
    return torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"


def describe(dev, peak: int, stretches) -> dict:
    """The result line's ``device``: with a profiled stretch, its busy and
    window seconds too."""
    cuda = torch.device(dev).type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu", "kind": name(dev), "count": 1, "memory_peak_bytes": peak}
    if stretches:
        out.update(busy_s=stretches[0].busy_s, window_s=stretches[0].window_s)
    return out
