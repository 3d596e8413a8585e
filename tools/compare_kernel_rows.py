#!/usr/bin/env python3
"""Compare the kernel rows of two ``chip_smoke.py`` logs.

    python3 tools/compare_kernel_rows.py OLD.log NEW.log [--keys bound_ms,bound_by,ops,bytes]

A kernel row is a JSON line with "kernel", "name" and "bound_ms" (the
kernel phases' rows and lm_conv's), keyed by (phase, kernel, name).  Prints
one JSON line: the rows in both, those whose keys differ (with both
values), and the rows in one log only; exits 1 if any row differs.
Device times vary from run to run and are not compared.
"""
from __future__ import annotations

import argparse
import json
import sys


def kernel_rows(path: str) -> dict:
    rows = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and {"kernel", "name", "bound_ms"} <= obj.keys():
                rows[(obj.get("phase"), obj["kernel"], obj["name"])] = obj
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--keys", default="bound_ms,bound_by,ops,bytes")
    args = ap.parse_args(argv)
    keys = args.keys.split(",")
    old, new = kernel_rows(args.old), kernel_rows(args.new)
    both = sorted(set(old) & set(new), key=str)
    differ = {" / ".join(map(str, k)): {key: (old[k].get(key), new[k].get(key)) for key in keys
                                        if old[k].get(key) != new[k].get(key)}
              for k in both}
    differ = {k: v for k, v in differ.items() if v}
    print(json.dumps({"rows_compared": len(both), "keys": keys, "differ": differ,
                      "only_old": [" / ".join(map(str, k)) for k in sorted(set(old) - set(new), key=str)],
                      "only_new": [" / ".join(map(str, k)) for k in sorted(set(new) - set(old), key=str)]}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
