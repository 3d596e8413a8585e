"""Readings that set a cell's limits, on the chip: the program's numbers on
many seeds, the control's (the plain reference in TF32, one precision
below the configuration's float32, in the program's place) and each fault
the cell can have, at the cell's own size.

    python3 bench/control.py --workload dcgan-train-b256 --seeds 12 --control-seeds 3 [--seconds 2]

Training reads no window (``--seconds 0``): set-up's checked steps are what
the reference follows.  Serving reads a short window at the cell's own
load.  One process reads every seed.  Each row also says whether its
numbers pass the cell's limits (``correct``), by the harness's own
comparison.  The benchmark's own runs never run this;
``tests/test_bench_control.py`` keeps it at a size a test run holds.
Prints one JSON line a reading and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench import correctness, harness, inputs  # noqa: E402
from bench.drivers import closed_loop, train_steps  # noqa: E402

SEED_BASE = 1_900_000_000  # large seeds, as the driver's


def half_batch_step(step):
    """Fault: the step sees the first half of each batch (its means taken
    over that half)."""
    def broken(gp, dp, g_opt, d_opt, z, real):
        return step(gp, dp, g_opt, d_opt, z[: z.shape[0] // 2], real[: real.shape[0] // 2])
    return broken


def unchanged_step(step):
    """Fault: the step returns its state unchanged."""
    def broken(gp, dp, g_opt, d_opt, z, real):
        out = step(gp, dp, g_opt, d_opt, z, real)
        return (gp, dp, g_opt, d_opt, out[4])
    return broken


def stale_leaf_step(step, leaf: str = "head.w"):
    """Fault: the optimizer leaves one leaf, the discriminator's head, where
    it was; its gradient and moments are right."""
    def broken(gp, dp, g_opt, d_opt, z, real):
        out = step(gp, dp, g_opt, d_opt, z, real)
        return (out[0], inputs.nest({**inputs.flatten(out[1]), leaf: inputs.flatten(dp)[leaf]}), *out[2:])
    return broken


def half_batch_generate(generate):
    """Fault: a generate computes the first half of its rows; the rest
    repeat it."""
    def broken(z):
        h = max(1, z.shape[0] // 2)
        img = generate(z[:h])
        return torch.cat([img, img])[: z.shape[0]]
    return broken


def altered_generate(generate):
    """Fault: one pixel of the first image of every generate is moved by
    0.01 where it is produced."""
    def broken(z):
        img = generate(z).clone()
        img[0, 0, 0, 0] += 0.01
        return img
    return broken


FAULTS = {
    "train_steps": {"half_batch": ("wrap_step", half_batch_step), "unchanged_state": ("wrap_step", unchanged_step),
                    "stale_leaf": ("wrap_step", stale_leaf_step)},
    "closed_loop": {"half_batch": ("wrap_generate", half_batch_generate),
                    "altered_answer": ("wrap_generate", altered_generate)},
}


def control_train(cell) -> dict:
    """The reference in TF32 against the reference in float32, on the
    inputs a run of ``cell`` hands both."""
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    raw = tuple({k: v.cpu() for k, v in t.items()} for t in inputs.draw_params(cfg, cell.seed, dev))
    feed, pool = train_steps.make_feed(cfg, tr, cell.seed, dev)
    zs, reals = [], []
    for s in range(tr["checked_steps"]):
        zs.append(torch.randn((tr["batch"], cfg["z_dim"]), generator=feed, device=dev).cpu())
        reals.append(pool[s % len(pool)].cpu())
    del pool
    kw = dict(lr=tr["lr"], b1=tr["b1"], device=dev)
    ref = train_steps.follow(cfg, raw, zs, reals, **kw)
    low = train_steps.follow(cfg, raw, zs, reals, tf32=True, **kw)
    return correctness.train_numbers(low, ref)


def control_serve(cell, n_images: int) -> dict:
    """The reference in TF32 against float32 over ``n_images`` images of
    the cell's own latents."""
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    raw_g = {k: v.cpu() for k, v in inputs.draw_params(cfg, cell.seed, dev)[0].items()}
    clients = closed_loop.Clients(tr, cfg["z_dim"], cell.seed)
    zs, n, c = [], 0, 0
    while n < n_images:
        zs.append(clients.next(c % tr["clients"]))
        n, c = n + zs[-1].shape[0], c + 1
    z = torch.cat(zs)
    ref = closed_loop.generate(cfg, raw_g, z, device=dev)
    low = closed_loop.generate(cfg, raw_g, z, device=dev, tf32=True)
    return {"image_gap": correctness.image_gap(low, ref)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seed-base", type=int, default=SEED_BASE)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "control.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 1
    sp = harness.spec()
    _, cfg, tr = harness.load_cell(sp, args.workload)
    lims = correctness.limits(args.workload)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    rows = []

    def cell(seed, hooks=None):
        return harness.Cell(args.workload, cfg, tr, lims, seed, args.seconds, False, "cuda", time.perf_counter(),
                            hooks or {})

    def emit(row):
        nums = {k: v for k, v in row.items() if k in lims}
        row.update(correct=correctness.passed(correctness.judge(nums, lims)), workload=args.workload,
                   device=torch.cuda.get_device_name(0))
        rows.append(row)
        print(json.dumps(harness.finite(row)), flush=True)

    kind = tr["kind"]
    for i in range(args.seeds):
        seed = args.seed_base + 7919 * i
        out = harness.driver(kind).run(cell(seed))
        emit({"reading": "program", "seed": seed, **out["numbers"],
              **({"serve_images": out["e2e"].get("serve_images_per_s")} if kind == "closed_loop" else {})})
        torch.cuda.empty_cache()
    for i in range(args.control_seeds):
        seed = args.seed_base + 7919 * i
        nums = control_train(cell(seed)) if kind == "train_steps" else control_serve(cell(seed), 4000)
        emit({"reading": "control_tf32", "seed": seed, **nums})
        torch.cuda.empty_cache()
    for name, (hook, wrap) in FAULTS[kind].items():
        for i in range(args.fault_seeds):
            seed = args.seed_base + 7919 * i
            out = harness.driver(kind).run(cell(seed, {hook: wrap}))
            emit({"reading": f"fault_{name}", "seed": seed, **out["numbers"]})
            torch.cuda.empty_cache()
    with open(args.out, "a") as f:
        for row in rows:
            f.write(json.dumps(harness.finite(row)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
