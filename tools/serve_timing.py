#!/usr/bin/env python3
"""Serving times of the PyTorch port's DCGAN, at its published widths, on
one GPU; and an interleaved comparison of several checkouts of the port.

    python3 tools/serve_timing.py                          # this checkout
    python3 tools/serve_timing.py --tree new=. --tree old=path/to/checkout \\
        --rounds 3 --out chiprun_out/serve_timing.json

Every measurement runs in a process of its own, which imports
``repro_torch`` from the checkout's ``src`` (and builds that checkout's
kernel into its own ``build/``).  Per round the trees run forward and then
backward (A B B A), so a drift of the host's speed during the run falls on
every tree alike.  Per tree it prints one JSON line per run and one with
the medians over all runs; then, for each tree after the first, the pairs
(run i of the first tree against run i of it) in which it was faster or
slower, the difference of the medians and the first tree's interquartile
spread.  ``--out`` gets all of it.

Numbers per batch size (1 and 8), random weights from seed 0, eval mode:
  generate_ms     CUDA-event time of 10 back-to-back ``generate`` calls, per
                  call; median of 5 such blocks
  host_ms         host time to issue one ``generate`` on an idle card (median of 50)
  request_p50_ms  submit -> result, host clock, ending in a synchronize (median of 50)
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 50
BLOCKS = 5  # generate_ms is the median over blocks of REPS // BLOCKS calls
BATCHES = (1, 8)
METRICS = ("generate_ms", "host_ms", "request_p50_ms")


def measure(src: Path) -> dict:
    """One run in this process, on the port found under ``src``."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("serve_timing: no CUDA device")
    sys.path.insert(0, str(src))
    from repro_torch.configs import DCGAN
    from repro_torch.kernels.engine import fused_engine
    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 as the reference serves
    eng = GanServeEngine(G.generator_init(DCGAN, seed=0, device="cuda"), DCGAN, batch=8, device="cuda")
    z1 = torch.randn((1, DCGAN.z_dim), generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    row = {}
    for b in BATCHES:
        z = z1.repeat(b, 1)
        for _ in range(5):
            eng.generate(z)
        torch.cuda.synchronize()
        spans = []
        for _ in range(BLOCKS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS // BLOCKS):
                eng.generate(z)
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end) / (REPS // BLOCKS))
        host, lat = [], []
        for _ in range(REPS):
            t = time.perf_counter()
            eng.generate(z)
            host.append(1e3 * (time.perf_counter() - t))
            torch.cuda.synchronize()
        for _ in range(REPS):
            t = time.perf_counter()
            eng.submit(z).result()
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t))
        row[b] = dict(generate_ms=statistics.median(spans), host_ms=statistics.median(host),
                      request_p50_ms=statistics.median(lat))
    if fused_engine.launches == 0:
        raise SystemExit("serve_timing: the fused kernel never ran")
    return row


def compare(trees: list[tuple[str, Path]], rounds: int, out: Path | None) -> None:
    order = [t for _ in range(rounds) for t in trees + trees[::-1]]
    runs: dict[str, list[dict]] = {label: [] for label, _ in trees}
    for label, root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root / "src")],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"serve_timing: run of {label} failed:\n{proc.stdout}\n{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(row)
        print(json.dumps({"tree": label, "run": len(runs[label]), **row}), flush=True)
    summary = {label: {b: {k: statistics.median(r[str(b)][k] for r in rs) for k in METRICS} for b in BATCHES}
               for label, rs in runs.items()}
    for label, med in summary.items():
        print(json.dumps({"tree": label, "median_of": len(runs[label]), **med}), flush=True)
    # each later tree against the first, run i against run i (every round
    # runs the first tree once before and once after each other tree)
    ref, ref_runs = trees[0][0], runs[trees[0][0]]
    pairs = {}
    for label, rs in list(runs.items())[1:]:
        pairs[label] = {}
        for b in BATCHES:
            for k in METRICS:
                a = [r[str(b)][k] for r in ref_runs]
                c = [r[str(b)][k] for r in rs]
                q = statistics.quantiles(a, n=4) if len(a) > 1 else [a[0], a[0], a[0]]
                pairs[label][f"{b}.{k}"] = dict(
                    pairs=len(c), faster=sum(y < x for x, y in zip(a, c)), slower=sum(y > x for x, y in zip(a, c)),
                    median_diff_ms=statistics.median(c) - statistics.median(a), ref_iqr_ms=q[2] - q[0])
        print(json.dumps({"tree": label, "against": ref, **pairs[label]}), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"order": [lb for lb, _ in order], "runs": runs, "median": summary,
                                   "against_" + ref: pairs}, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                    help="a checkout of the repo to time (repeat to compare)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(measure(args.worker.resolve())), flush=True)
        return 0
    trees = [(lb, Path(d).resolve()) for lb, d in (t.split("=", 1) for t in args.tree)]
    compare(trees or [("this", Path(__file__).resolve().parents[1])], args.rounds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
