#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  env     torch / CUDA versions, the card's name and power limit; TF32 off.
  build   nvcc builds src/repro_torch/kernels/csrc/fused_engine.cu (sm_90a).
  kernel  the fused Winograd-DeConv kernel against its plain PyTorch version
          at the four DCGAN layer shapes (batch 8) and a K4S2, a K3S1 and a
          K2S3 shape, each also checked against conv_transpose2d plus the same
          epilogue; kernel, plain and library device times (profiler, mean
          of 20 calls) and wall times (CUDA events, median of >= 20 calls).
  serve   DCGAN at its published widths through GanServeEngine (random
          weights from a seed): requests of 1, 3 and 8 images, then a run of
          more; checks the images against the plain-version generator, and
          that the kernel ran exactly 4 times per generate; images/s.
  kernels one summary line per kernel (launches on the serving path, error,
          times, the least time the card could take).
Then the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero
without that line; without a CUDA device, or without the package beside
this script, it exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/fused_engine.cu"
REPLACES = "src/repro/kernels/engine.py:817"  # fused_engine's epilogue pallas_call

# (fp32 FLOP/s outside the tensor cores, HBM bytes/s) from NVIDIA's data sheets
PEAKS = {
    "PCIe": (51.2e12, 2.0e12),
    "NVL": (60.0e12, 3.9e12),
    "SXM": (66.9e12, 3.35e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def wall_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """CUDA-event time of ``reps`` back-to-back calls, per call (ms): what a
    caller waits, host overhead included where the host is the slower side."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def event_median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median over ``reps`` single calls of the CUDA-event time around one
    call (ms), after a warm-up: one isolated call, host overhead included."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled_ms(fn, reps: int = 10, warmup: int = 3, name: str = ""):
    """One profiled run of ``reps`` back-to-back calls: (wall ms per call from
    CUDA events around the run, device ms per call from the profiler, device
    ms per call of the kernels whose name contains ``name``, device ms per
    call of each kernel by name).  The device time is taken inside the wall
    time it is compared with."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    total = sum(e.device_time_total for e in evs)
    named = sum(e.device_time_total for e in evs if name and name in e.key)
    if total <= 0 or (name and named <= 0):
        fail(f"the profiler recorded no device time{' for ' + name if name else ''}")
    by_kernel = {e.key: e.device_time_total / reps / 1e3 for e in evs if e.device_time_total > 0}
    return a.elapsed_time(b) / reps, total / reps / 1e3, named / reps / 1e3, by_kernel


def cells_to_image(c, out_hw, padding):
    """(B, R, Cc, 4, M) emitted cells -> the cropped NHWC image."""
    B, R, Cc, _, M = c.shape
    img = c.reshape(B, R, Cc, 2, 2, M).permute(0, 1, 3, 2, 4, 5).reshape(B, R * 2, Cc * 2, M)
    return img[:, padding : padding + out_hw[0], padding : padding + out_hw[1]]


def kernel_phase(torch, peaks):
    import torch.nn.functional as F

    from repro_torch.core.tdc import DeconvDims
    from repro_torch.kernels import engine, ops
    from repro_torch.kernels.ref import epilogue_apply_ref

    K5, K4, K3, K2S3 = DeconvDims(5, 2, 2, 1), DeconvDims(4, 2, 1, 0), DeconvDims(3, 1, 1, 0), DeconvDims(2, 3, 0, 0)
    # name, dims, B, H, N, M, emit_cells, activation, affine
    shapes = [
        ("dcgan.deconv0", K5, 8, 4, 1024, 512, True, "relu", True),
        ("dcgan.deconv1", K5, 8, 8, 512, 256, True, "relu", True),
        ("dcgan.deconv2", K5, 8, 16, 256, 128, True, "relu", True),
        ("dcgan.deconv3", K5, 8, 32, 128, 3, False, "tanh", False),
        ("k4s2", K4, 8, 8, 256, 128, True, "leaky_relu", True),
        ("k3s1", K3, 8, 32, 64, 3, False, "tanh", False),
        ("k2s3", K2S3, 2, 8, 32, 16, False, "relu", True),
    ]
    flops_peak, bytes_peak = peaks
    rows = []
    for i, (name, dims, B, H, N, M, emit_cells, act, affine) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.randn((B, H, H, N), generator=g, device="cuda")
        w = 0.02 * torch.randn((dims.kernel, dims.kernel, N, M), generator=g, device="cuda")
        scale = (1.0 + 0.1 * torch.randn((M,), generator=g, device="cuda")) if affine else None
        bias = (0.1 * torch.randn((M,), generator=g, device="cuda")) if affine else None
        packed = ops.prepack(w, dims)
        cells = ops.cells_from_image(x, dims)
        kw = dict(epilogue=act, scale=scale, bias=bias, emit_cells=emit_cells)
        run = lambda backend: ops.winograd_deconv2d_cells(cells, packed, dims, (H, H), backend=backend, **kw)  # noqa: E731
        got = run("cuda")
        torch.cuda.synchronize()
        want = run("ref")
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item() + 1e-5
        if not err <= tol:
            fail(f"kernel vs plain at {name}: max|err| {err:.3e} > {tol:.3e}")

        HO = dims.out_size(H)
        wt = w.permute(2, 3, 0, 1).contiguous()
        xc = x.permute(0, 3, 1, 2).contiguous()

        def library():
            y = F.conv_transpose2d(xc, wt, stride=dims.stride, padding=dims.padding,
                                   output_padding=dims.output_padding)
            return epilogue_apply_ref(y.permute(0, 2, 3, 1), scale, bias, act)

        lib_img = library()
        got_img = cells_to_image(got, (HO, HO), dims.padding) if emit_cells else got
        lib_err = (got_img - lib_img).abs().max().item()
        lib_tol = 1e-4 * lib_img.abs().max().item() + 1e-5
        if not lib_err <= lib_tol:
            fail(f"kernel vs conv_transpose2d at {name}: max|err| {lib_err:.3e} > {lib_tol:.3e}")

        ms = profiled_ms(lambda: run("cuda"), reps=20, name="fused_epi_kernel")[2]
        plain_ms = profiled_ms(lambda: run("ref"), reps=20)[1]
        _, library_ms, _, library_kernels = profiled_ms(library, reps=20)
        walls = dict(ms_wall=event_median_ms(lambda: run("cuda")),
                     plain_ms_wall=event_median_ms(lambda: run("ref"), reps=20),
                     library_ms_wall=event_median_ms(library, reps=20))

        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        C = len(pos_idx)
        ty = -(-dims.j_extent(H) // 2)
        splits = engine._plan(B, ty, ty, N, M, dims.stride, torch.cuda.current_device())[0]
        T = B * ty * ty
        n_bytes = 4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + got.numel()
                       + (2 * M if affine else 0))
        # com-PE products, the pre-PE adder network (32 adds per tile and
        # channel), the post-PE fold (4 multiply-adds per position) and the
        # epilogue (affine + activation per output value)
        n_ops = 2 * T * C * N * M + 32 * T * N + 8 * T * C * M + 3 * got.numel()
        t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
        row = dict(name=name, B=B, H_in=H, N=N, M=M, C=C, T=T, n_splits=splits,
                   out_mode="cells" if emit_cells else "nhwc", activation=act,
                   max_abs_err=err, tol=tol, library_max_abs_err=lib_err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_kernels=library_kernels, **walls,
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=n_bytes, ops=n_ops,
                   achieved_tflops=n_ops / (ms * 1e-3) / 1e12)
        emit({"phase": "kernel", **row})
        rows.append(row)
    return rows


def serve_phase(torch, card):
    import dataclasses

    from repro_torch.configs import DCGAN
    from repro_torch.kernels.engine import fused_engine
    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine

    t0 = time.perf_counter()
    params = G.generator_init(DCGAN, seed=0, device="cuda")
    # non-trivial eval-mode batchnorm and stem bias, so the resident's folded
    # affine is held to more than an identity
    g = torch.Generator(device="cuda").manual_seed(2)
    params["stem"]["b"] = 0.1 * torch.randn(params["stem"]["b"].shape, generator=g, device="cuda")
    for k, bn in params.items():
        if k.endswith("_bn"):
            c = bn["mean"].shape[0]
            bn["mean"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
            bn["var"] = 0.5 + torch.rand((c,), generator=g, device="cuda")
            bn["scale"] = 1.0 + 0.2 * torch.randn((c,), generator=g, device="cuda")
            bn["bias"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
    eng = GanServeEngine(params, DCGAN, batch=8, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = eng.archs[DCGAN.arch_id]
    g = torch.Generator(device="cuda").manual_seed(1)
    sizes_submit, sizes_run = (1, 3, 8), (2, 5, 8, 1, 4)
    zs = [torch.randn((b, DCGAN.z_dim), generator=g, device="cuda") for b in sizes_submit + sizes_run]

    # --- the main path: counts at 0 just before, read just after
    fused_engine.launches = 0
    gen0 = res.generates
    futs = [eng.submit(z) for z in zs[: len(sizes_submit)]]
    outs = [f.result() for f in futs]
    outs += eng.run(zs[len(sizes_submit):])
    torch.cuda.synchronize()
    launches = fused_engine.launches
    generates = res.generates - gen0
    if generates == 0 or launches != 4 * generates:
        fail(f"{launches} kernel launches for {generates} generates (want 4 per generate)")

    ref_cfg = dataclasses.replace(eng.cfg, deconv_impl="chained_ref")
    worst, worst_tol = 0.0, 0.0
    with torch.inference_mode():
        for z, o in zip(zs, outs):
            if tuple(o.shape) != (z.shape[0], 64, 64, 3):
                fail(f"served shape {tuple(o.shape)} for a request of {z.shape[0]}")
            if not torch.isfinite(o).all() or o.abs().max().item() > 1.0:
                fail("served images not finite or outside [-1, 1]")
            want, _ = G.generator_apply(eng.params, ref_cfg, z)
            err = (o - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-5
            if not err <= tol:
                fail(f"served image vs plain generator: max|err| {err:.3e} > {tol:.3e}")
            worst, worst_tol = max(worst, err), max(worst_tol, tol)
    emit({"phase": "serve", "arch": "dcgan", "requests": len(zs), "images": sum(z.shape[0] for z in zs),
          "dispatch_log": eng.dispatch_log, "bucket_counts": eng.bucket_counts,
          "generates": generates, "launches": launches, "max_abs_err_vs_plain": worst,
          "tol": worst_tol, "out_std": float(torch.cat([o.flatten() for o in outs]).std()),
          "setup_s": setup_s, "card": card})

    # --- throughput and latency (after the counted run)
    for b in (1, 8):
        z = zs[-1][:1].repeat(b, 1)
        gen_ms = wall_ms(lambda: eng.generate(z))
        prof_ms, dev_ms, kern_ms, _ = profiled_ms(lambda: eng.generate(z), name="fused_epi_kernel")
        idle = 1.0 - dev_ms / prof_ms
        if idle < 0.0:
            fail(f"device time {dev_ms:.4f} ms exceeds the wall time {prof_ms:.4f} ms it was taken in")
        plain_ms = wall_ms(lambda: G.generator_apply(eng.params, ref_cfg, z), reps=10)
        lat = []
        for _ in range(20):
            t = time.perf_counter()
            eng.submit(z).result()
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t))
        rate = dict(generate_ms=gen_ms, images_per_s=1e3 * b / gen_ms, device_ms=dev_ms,
                    fused_kernel_ms=kern_ms, profiled_generate_ms=prof_ms, device_idle_share=idle,
                    plain_generate_ms=plain_ms, request_latency_ms_p50=statistics.median(lat),
                    request_latency_ms_max=max(lat))
        emit({"phase": "serve_rate", "batch": b, **rate, "card": card})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    # fp32 as the reference serves: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(kind)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda, "device": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi, "peak_table": peak_key,
          "peak_fp32_flops": peaks[0], "peak_bytes_per_s": peaks[1]})

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.last_build_log.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.last_build_log.get("seconds"), "ptxas": ptxas,
          "library": str(_build.library_path().relative_to(ROOT))})

    rows = kernel_phase(torch, peaks)
    launches = serve_phase(torch, smi)

    main_rows = [r for r in rows if r["name"].startswith("dcgan.")]
    tot = {k: sum(r[k] for r in main_rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    emit({"kernels": [{
        "name": "fused_engine_epi", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        # one DCGAN generate at batch 8: the four layer shapes summed
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if sum(1e3 * r["bytes"] / peaks[1] for r in main_rows)
        >= sum(1e3 * r["ops"] / peaks[0] for r in main_rows) else "operations",
        "library_ms": tot["library_ms"],
        "shapes": [{k: r[k] for k in ("name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                      "max_abs_err")} for r in rows],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
