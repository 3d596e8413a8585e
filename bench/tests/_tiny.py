"""Tiny cells for CPU tests: a configuration's file with every width cut
to a few channels (the port's chained impls take their plain versions on
CPU tensors), and the cell's traffic mix at a few rows."""
from __future__ import annotations

import json
import time

from bench import harness

SEED = 2**31 + 12345  # larger than 32 signed bits hold, as the driver's seeds


def tiny_cfg(name: str) -> dict:
    cfg = json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
    cfg.pop("port_config")
    cfg["stem_ch"] = 8
    n = len(cfg["deconvs"])
    for i, d in enumerate(cfg["deconvs"]):
        d["c_in"] = 8 if i == 0 else 4
        d["c_out"] = 3 if i == n - 1 else 4
    cfg["disc_channels"] = [4, 4, 4, 4]
    return cfg


def tiny_traffic(name: str) -> dict:
    tr = json.loads((harness.BENCH / "traffic" / f"{name}.json").read_text())
    if tr["kind"] == "train_steps":
        tr.update(batch=2, real_pool=2)
    else:
        tr.update(clients=3, pool_rows=8, sample_every=1, warm_seconds=0.0)  # few dispatches: check every answer
    return tr


def tiny_cell(workload: str, *, seconds: float = 0.3, trace: bool = False, hooks=None, limits=None,
              seed: int = SEED) -> harness.Cell:
    wl, _, _ = harness.load_cell(harness.spec(), workload)
    from bench import correctness

    return harness.Cell(workload, tiny_cfg(wl["config"]), tiny_traffic(wl["traffic"]),
                        limits if limits is not None else correctness.limits(workload), seed, seconds, trace, "cpu",
                        time.perf_counter(), hooks or {})
