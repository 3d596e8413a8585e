"""Re-run the op cost model over saved op records (no new trace; the
reference's ``launch/reanalyze.py``, which re-reads its ``.hlo.gz``).

Usage: python -m repro_torch.launch.reanalyze [--dir artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from . import op_costs
from .dryrun import ART_DIR, CARD_BYTES, read_ops

__all__ = ["reanalyze", "main"]


def reanalyze(directory: str) -> list[str]:
    """Recompute ``hlo_costs`` and ``collectives`` of every ``<cell>.json``
    in ``directory`` from its ``<cell>.ops.jsonl.gz``, and ``fits_80gb``
    from its peak live bytes; the cells done."""
    done = []
    for gz in sorted(glob.glob(os.path.join(directory, "*.ops.jsonl.gz"))):
        jpath = gz[: -len(".ops.jsonl.gz")] + ".json"
        if not os.path.exists(jpath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        records = read_ops(gz)
        rec["hlo_costs"] = op_costs.analyze_records(records)
        rec["collectives"] = op_costs.collective_stats(records)
        rec["memory"]["fits_80gb"] = rec["memory"]["peak_live_bytes"] <= CARD_BYTES
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        done.append(os.path.basename(jpath))
        print(f"reanalyzed {os.path.basename(jpath)}: flops/dev={rec['hlo_costs']['flops_per_device']:.3e}")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=ART_DIR)
    args = ap.parse_args(argv)
    print(f"done: {len(reanalyze(args.dir))} artifacts")


if __name__ == "__main__":
    main()
