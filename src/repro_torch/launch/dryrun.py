"""Multi-pod dry run: trace one rank's step of every (arch x shape x mesh)
cell on fake tensors (the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell on a forced 512-device host
and reads the partitioned program.  The port runs one process a rank, so a
cell is one rank's view: a ``"fake"`` process group of the mesh's world
(256 or 512 ranks, this process rank 0; collectives run nothing),
``make_mesh(*make_production_mesh(...))`` over it, ``build_step``'s
argument structs filled with that rank's blocks as fake tensors (shapes,
dtypes and a device, no storage), and the step run once under
``op_costs.OpRecorder``.  Per cell it writes ``<cell>.json`` (the
reference's keys where they exist: ``meta``, ``sharding_fallbacks``,
``collectives``, ``hlo_costs``, ``status``; ``t_trace_s`` where the
reference has lower and compile times; ``memory`` where it has
``memory_analysis``) and ``<cell>.ops.jsonl.gz``, the op record, where the
reference gzips the HLO (``launch/reanalyze.py`` re-reads it).

Memory is counted, not allocated: the rank's argument bytes, output bytes
and the most bytes live at once during the step (every storage from its
first op to its last reference), and whether that fits one H100 80GB HBM3
(``fits_80gb``: at most ``CARD_BYTES``, the card's memory as torch reports
it).

A step that reads device data on the host cannot run on fake tensors: the
cell gets ``status: "error"`` with the reason, never ``ok``.  The registry
configs run as they stand (the GANs at ``deconv_impl="ref"`` /
``conv_impl="lax"``, the SSM conv ``"direct"``), so no kernel launches.

The device is ``"cuda"`` where this torch is built with CUDA (no card is
needed: the tensors are fake), else ``"cpu"``: a CPU-only build cannot
index a fake CUDA tensor.  The registry configs run the same ops on both.

Usage:
  python -m repro_torch.launch.dryrun                      # full sweep (skip done)
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --multi-pod ...      # 2x16x16 mesh
  python -m repro_torch.launch.dryrun --both-meshes        # 16x16 and 2x16x16
  python -m repro_torch.launch.dryrun --force              # recompute
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..configs import REGISTRY, SHAPES, get_config, shape_applicable
from ..configs.base import GANConfig
from ..core.winograd_deconv import clear_device_constants
from ..parallel import sharding as SH
from . import op_costs
from .mesh import make_mesh, make_production_mesh
from .steps import build_step

__all__ = ["ART_DIR", "CARD_BYTES", "cell_name", "default_device", "fake_world", "trace_step", "run_cell", "main"]

ART_DIR = os.path.join(os.path.dirname(__file__), "../../../artifacts/dryrun_torch")
# one card's memory: the total_memory torch reports for an NVIDIA H100 80GB HBM3 (81079 MiB), no reserve kept
CARD_BYTES = 85_017_493_504


def cell_name(arch: str, shape: str, multi_pod: bool) -> str:
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    return f"{arch}__{shape}__{mesh}"


def default_device() -> str:
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def fake_world(world: int) -> bool:
    """Bring up a ``"fake"`` process group of ``world`` ranks, this process
    rank 0; True when this call created it (the caller destroys it).  An
    existing group of that size and backend is kept."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the "fake" backend

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return False
        raise RuntimeError(f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is up: "
                           f"the dry run needs a fake one of {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return True


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def trace_step(fn, arg_structs, in_specs, mesh, *, device, dtype=None) -> dict:
    """Run ``fn`` once on this rank's blocks of ``arg_structs`` (meta
    tensors under ``in_specs``), as fake tensors on ``device`` (floating
    leaves cast to ``dtype`` where given), under the recorder.  Returns the
    records, ``t_trace_s`` and the memory counts; raises what the step
    raises (a host read on fake tensors among them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode()

    def fill(t, spec):
        b = SH.block_of(t, spec, mesh)
        dt = dtype if dtype is not None and b.dtype.is_floating_point else b.dtype
        with fake:
            return torch.empty(b.shape, dtype=dt, device=device)

    args = tuple(SH.map_specs(fill, a, s) for a, s in zip(arg_structs, in_specs))
    held = op_costs.tensors_of(args)
    arg_bytes = _storage_bytes(held)
    rec = op_costs.OpRecorder(track_memory=True)
    rec.hold(held)
    # the device constants are built on this trace's fake tensors and dropped with it: no real constant
    # enters the trace, no fake one stays in the caches
    clear_device_constants()
    t0 = time.time()
    try:
        with fake, rec:
            out = fn(*args)
    finally:
        clear_device_constants()
    t_trace = time.time() - t0
    outs = op_costs.tensors_of(out)
    return {"records": rec.records, "t_trace_s": round(t_trace, 2),
            "memory": {"argument_bytes": arg_bytes, "output_bytes": _storage_bytes(outs),
                       "peak_live_bytes": rec.peak_live_bytes, "fits_80gb": rec.peak_live_bytes <= CARD_BYTES}}


def _json_meta(meta: dict) -> dict:
    def ok(v):
        try:
            json.dumps(v)
            return True
        except TypeError:
            return False

    return {k: v for k, v in meta.items() if k not in ("fallbacks", "in_specs") and ok(v)}


def write_ops(path: str, records: list) -> None:
    with gzip.open(path, "wt") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def read_ops(path: str) -> list:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f]


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, mesh=None, *, device=None,
             dtype=None) -> dict:
    """Trace one cell and write its artifacts to ``out_dir``.  ``mesh`` is
    ``(shape, axis names)`` (default: the production mesh); ``device`` the
    fake tensors' device (``default_device()``); ``dtype`` casts the
    floating arguments (default: the structs' ``PARAM_DTYPE``, as the
    reference)."""
    shape, axes = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    device = device or default_device()
    n_dev = int(np.prod(shape))
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": list(shape), "axis_names": list(axes),
                 "n_devices": n_dev, "device": device}
    name = cell_name(arch, shape_name, multi_pod)
    created = fake_world(n_dev)
    try:
        m = make_mesh(shape, axes, device=device)
        fn, args, meta = build_step(arch, shape_name, m)
        rec["meta"] = _json_meta(meta)
        rec["sharding_fallbacks"] = meta.get("fallbacks", [])
        try:
            traced = trace_step(fn, args, meta["in_specs"], m, device=device, dtype=dtype)
        except Exception as e:  # a host read, a data-dependent shape, or any other fault of the step
            rec.update(status="error", error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc()[-3000:])
            print(f"  trace failed: {rec['error'][:200]}")
            return rec
        records = traced.pop("records")
        rec.update(traced)
        rec["collectives"] = op_costs.collective_stats(records)
        rec["hlo_costs"] = op_costs.analyze_records(records)
        rec["n_ops"] = len(records)
        write_ops(os.path.join(out_dir, name + ".ops.jsonl.gz"), records)
        c = rec["hlo_costs"]
        print(f"  t_trace={rec['t_trace_s']}s flops/dev={c['flops_per_device']:.3e} "
              f"bytes/dev={c['hbm_bytes_per_device']:.3e} wire/dev={c['collective_wire_bytes_per_device']:.3e} "
              f"peak={rec['memory']['peak_live_bytes'] / 1e9:.2f} GB")
        rec["status"] = "ok"
        return rec
    finally:
        if created:
            dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all applicable)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ART_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    archs = [args.arch] if args.arch else sorted(REGISTRY)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        if isinstance(cfg, GANConfig):
            shapes = ["gan_train"]
        else:
            shapes = [args.shape] if args.shape else list(SHAPES)
        for shape_name in shapes:
            if shape_name != "gan_train":
                ok, why = shape_applicable(cfg, SHAPES[shape_name])
                if not ok:
                    n_skip += 1
                    print(f"SKIP {arch} x {shape_name}: {why}")
                    continue
            for mp in meshes:
                name = cell_name(arch, shape_name, mp)
                path = os.path.join(args.out, name + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"DONE {name} (cached)")
                    n_ok += 1
                    continue
                print(f"RUN  {name}", flush=True)
                try:
                    rec = run_cell(arch, shape_name, mp, args.out)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape_name, "multi_pod": mp, "status": "error",
                           "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-3000:]}
                    print(f"FAIL {name}: {type(e).__name__}: {str(e)[:200]}")
                if rec["status"] == "ok":
                    n_ok += 1
                else:
                    n_fail += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"dry-run complete: ok={n_ok} fail={n_fail} skip={n_skip}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
