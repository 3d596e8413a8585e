"""One run of one cell: ``python3 bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``'s ``workloads``; its configuration's file
(``configs/<name>.json``) and its traffic mix (``traffic/<name>.json``),
whose ``kind`` names the driver (``drivers/<kind>.py``) that runs it; its
limits (``limits/<workload>.json``); and each per-layer metric's reader
(``metrics/<metric name>.py``, a ``read(ctx)`` that returns a number or
None).  A new cell, mix, configuration or metric is new files and entries,
and no edit here.

The result is one JSON line, the last of standard output; the numbers
that decided ``correct`` are the last lines of standard error and the
line's last key (``checks``).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Optional

from . import correctness

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_THREADS = 2  # the load comes from one process with few threads: steadier runs


@dataclasses.dataclass
class Cell:
    """One run's inputs, as a driver takes them."""

    workload: str
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # the process's start, on time.perf_counter's clock
    hooks: dict = dataclasses.field(default_factory=dict)  # test-only breakage of the timed path
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(sp: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell, by name."""
    wl = next((w for w in sp["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"bench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in sp["configs"] if c["name"] == wl["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{wl['traffic']}.json").read_text())
    return wl, cfg, traffic


def driver(kind: str):
    return importlib.import_module(f"{__package__}.drivers.{kind}")


def _applies(entry: dict, workload: str, e2e_names: set) -> bool:
    """A per-layer metric with no ``workloads`` is read in every cell that
    reports the end-to-end metric it moves, later cells too."""
    if "workloads" in entry:
        return workload in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def e2e_metrics(sp: dict, workload: str) -> list[dict]:
    return [m for m in sp["end_to_end"] if "workloads" not in m or workload in m["workloads"]]


def layer_metrics(sp: dict, workload: str) -> list[dict]:
    names = {m["name"] for m in e2e_metrics(sp, workload)}
    return [m for m in sp["per_layer"] if _applies(m, workload, names)]


def reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"{__package__}.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: Cell, sp: dict) -> tuple[dict, dict]:
    """Drive one run: (its result line, every number the comparison read,
    limited or not)."""
    out = driver(cell.traffic["kind"]).run(cell)
    metrics: dict[str, Any] = {}
    st = out["ctx"].get("stretch")
    if st is not None:
        launched = st.family_launches()
        for fam in sorted(set(launched) | set(st.family_records)):
            cell.log(f"trace {fam}: {st.family_records.get(fam, 0)} kernel records, {launched.get(fam, 0)} launches "
                     f"logged" + ("" if st.whole(fam) else " (short: no roofline share from this family)"))
    if cell.trace:
        for m in layer_metrics(sp, cell.workload):
            value = reader(m["name"])(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e_metrics(sp, cell.workload):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    checks = correctness.judge(out["numbers"], cell.limits)
    result = {
        "correct": correctness.passed(checks) and not out.get("missing", 0),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": out["device"],
    }
    if cell.trace and out.get("breakdown") is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    if out.get("missing"):
        result["checks"]["missing_answers"] = {"value": out["missing"], "limit": 0}
    return result, out["numbers"]


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process (top-level
    names compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv: Optional[list[str]], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sp = spec()
    wl, cfg, traffic = load_cell(sp, args.workload)

    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"bench: the cell needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    cell = Cell(args.workload, cfg, traffic, correctness.limits(args.workload), args.seed, args.seconds,
                bool(args.trace), "cuda", t_start)
    result, readings = run_cell(cell, sp)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 4
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    for name, value in readings.items():
        print(f"reading {name} {value!r}", file=sys.stderr, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


def finite(obj):
    """``obj`` with every non-finite float as null (strict JSON)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj
