"""The numbers that decide ``correct``, each against its limit.

Training (``train_numbers``): the program's first steps against the plain
reference's from the same raw weights, latents and images:
  * ``loss_gap``: the widest relative gap of a step's G or D loss;
  * ``grad_gap``: step 1's gradient as the optimizer got it (the program's
    first moment after one step over 1 - b1), worst leaf: the gap between
    the two norms of a leaf over the larger of the reference's norm of that
    leaf and of the median leaf;
  * ``change_gap``: the parameters' change over the checked steps, worst
    leaf, measured the same way, over the leaves whose reference gradient
    is at least a thousandth of the median leaf's (a bias ahead of a
    batchnorm has a gradient of rounding only, and Adam moves it by
    round-off alone; running statistics have none);
  * ``update_gap``: each checked step's optimizer update against the plain
    AdamW step applied to the run's own moments, worst leaf and step.  It
    needs no second run, so the sign of a tiny gradient does not enter it:
    it is rounding, or a leaf updated wrongly.
Serving (``image_gap``): the widest gap of a served image's pixel to the
reference's, over the largest reference pixel of the sample.

A limit lives in ``limits/<workload>.json``; a number that is not finite
fails.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import torch

from .reference import gan as R

LIMITS = Path(__file__).resolve().parent / "limits"


def limits(workload: str) -> dict:
    return json.loads((LIMITS / f"{workload}.json").read_text())["limits"]


def judge(values: dict, lims: dict) -> list[tuple[str, float, float]]:
    """(name, value, limit) for every limited number; a number the run did
    not produce reads inf."""
    return [(k, float(values.get(k, math.inf)), float(lim)) for k, lim in lims.items()]


def passed(checks) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def worst(xs) -> float:
    """The largest of ``xs``; NaN if any is NaN (``max`` would skip it)."""
    xs = [float(x) for x in xs]
    return math.nan if any(math.isnan(x) for x in xs) else max(xs, default=0.0)


def _gaps(prog: dict, ref: dict, keys) -> list[float]:
    """Each leaf's gap of norms over the larger of the reference's norm of
    that leaf and of the median leaf."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]


def _median(xs) -> float:
    xs = [float(x) for x in xs]
    return math.nan if not xs or any(math.isnan(x) for x in xs) else statistics.median(xs)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"losses": [(g, d) per step], "grad": {leaf:
    step-1 gradient}, "p0": {leaf: start}, "p_end": {leaf: after the
    checked steps}, "update_gap": the worst of ``update_gap`` over its
    checked steps}; ``ref`` also names its trainable leaves
    (``trainable``).  Besides the three numbers above: the first step's
    loss gap (``loss_gap_first``) and the median leaf's gap of the gradient
    and of the change (``*_median``)."""
    pairs = [[abs(p - r) / abs(r) for p, r in zip(ps, rs)] for ps, rs in zip(prog["losses"], ref["losses"])]
    g_p, g_r = _norms(prog["grad"]), _norms(ref["grad"])
    trainable = ref["trainable"]
    med = statistics.median(g_r[k] for k in trainable)
    moved = [k for k in trainable if g_r[k] >= 1e-3 * med]
    d_p = _norms({k: prog["p_end"][k] - prog["p0"][k] for k in moved})
    d_r = _norms({k: ref["p_end"][k] - ref["p0"][k] for k in moved})
    grads, changes = _gaps(g_p, g_r, trainable), _gaps(d_p, d_r, moved)
    out = {"loss_gap": worst(x for row in pairs for x in row), "loss_gap_first": worst(pairs[0] if pairs else []),
           "grad_gap": worst(grads), "grad_gap_median": _median(grads),
           "change_gap": worst(changes), "change_gap_median": _median(changes),
           "update_gap": float(prog.get("update_gap", math.inf))}
    if len(prog["losses"]) != len(ref["losses"]) or not pairs:
        out["loss_gap"] = out["loss_gap_first"] = math.inf
    return out


def update_gap(before: dict, after: dict, m: dict, v: dict, t: int, keys, *, lr: float, b1: float) -> float:
    """Step ``t``'s worst trainable leaf: the norm of the gap between the
    leaf the step returned (``after``) and AdamW's step from the leaf it
    got (``before``) and the moments it left (``m``, ``v``), in float64,
    over the larger of that leaf's and the median leaf's update norm."""
    gaps, steps = {}, {}
    for k in keys:
        x = before[k].double()
        want = R.adam_apply(x, m[k].double(), v[k].double(), t, lr=lr, b1=b1)
        gaps[k] = float(torch.linalg.vector_norm(after[k].double() - want))
        steps[k] = float(torch.linalg.vector_norm(want - x))
    med = statistics.median(steps.values())
    return worst(gaps[k] / max(steps[k], med) if max(steps[k], med) > 0 else (math.inf if gaps[k] else 0.0)
                for k in keys)


def image_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    if prog.shape != ref.shape:
        return math.inf
    return float((prog.double() - ref.double()).abs().max() / ref.double().abs().max())
