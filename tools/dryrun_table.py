#!/usr/bin/env python3
"""Print the dry run's cells (``python -m repro_torch.launch.dryrun``'s
``<cell>.json`` files) on one mesh as a markdown table: one row an arch,
one column a shape, each cell "FLOPs / f32 matmul FLOPs / HBM bytes /
collective wire bytes / peak live GB / t_trace_s" of one rank, the peak in
bold past one card's memory (``dryrun.CARD_BYTES``, 85.0e9 bytes); a failed
cell with its reason.

    python3 tools/dryrun_table.py [--dir artifacts/dryrun_torch] [--mesh pod16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("gan_train", "train_4k", "prefill_32k", "decode_32k", "long_500k")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.join(ROOT, "artifacts", "dryrun_torch"))
    ap.add_argument("--mesh", default="pod16x16", help="pod16x16 or pod2x16x16")
    args = ap.parse_args(argv)
    cells: dict = {}
    for path in sorted(glob.glob(os.path.join(args.dir, f"*__{args.mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        arch, shape = os.path.basename(path).split("__")[:2]
        if rec.get("status") != "ok":
            cells.setdefault(arch, {})[shape] = f"error: {rec.get('error', '')[:60]}"
            continue
        c, m = rec["hlo_costs"], rec["memory"]
        peak = f"{m['peak_live_bytes'] / 1e9:.1f}"
        cells.setdefault(arch, {})[shape] = (
            f"{c['flops_per_device']:.2e} / {c['f32_matmul_flops_per_device']:.1e} / {c['hbm_bytes_per_device']:.1e} / "
            f"{c['collective_wire_bytes_per_device']:.1e} / {peak if m['fits_80gb'] else f'**{peak}**'} / "
            f"{rec['t_trace_s']}")
    shapes = [s for s in SHAPES if any(s in v for v in cells.values())]
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    for arch in sorted(cells):
        print(f"| {arch} | " + " | ".join(cells[arch].get(s, "—") for s in shapes) + " |")


if __name__ == "__main__":
    main()
