#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernel,kernel_bwd,kernel_conv,kernel_domain,serve,train,train_chained,
                                    serve_per_layer,train_per_layer]

Phases, each printing one JSON line:
  env     torch / CUDA versions, the card's name and power limit; TF32 off.
  build   nvcc builds the kernels in src/repro_torch/kernels/csrc/ (sm_90a):
          fused_engine.cu, fused_engine_bwd.cu, conv_engine.cu,
          domain_engine.cu.
  kernel  the fused Winograd-DeConv kernel against its plain PyTorch version
          at the four DCGAN layer shapes (batch 8) and a K4S2, a K3S1 and a
          K2S3 shape, each also checked against conv_transpose2d plus the same
          epilogue; kernel, plain and library device times (profiler, mean
          of 20 calls) and wall times (CUDA events, median of >= 20 calls).
  kernel_bwd
          the two backward kernels (fused_engine_bwd.cu) against their plain
          versions at the four DCGAN layer shapes at the training batch 128
          and the K4S2, K3S1 and K2S3 shapes above; device, one-call and
          plain times, the bound, and as a yardstick aten's
          convolution_backward of the layer's conv_transpose2d (input grad
          for bwd_x, raw-weight grad for bwd_w).  Also the forward kernel at
          the four training shapes (batch 128).
  kernel_conv
          the three conv-corner kernels (conv_engine.cu: forward, bwd_x,
          bwd_w) against their plain versions at the DCGAN discriminator's
          four layers at batch 128 and an odd-extent K4S2, a K3S2 and a K3S1
          shape; device, one-call and plain times, the bound, and as
          yardsticks F.conv2d plus the epilogue and aten's
          convolution_backward (input grad, raw-weight grad).
  kernel_domain
          the per-layer path's kernels: the unfused engine and its backward
          (domain_engine.cu: kernels 1, 4, 5) against their plain versions at
          the four DCGAN layer shapes at batch 128 and the K4S2, K3S1 and
          K2S3 shapes, kernel 1 also at the four layers at batch 8 (as it
          serves); the fused engine's scratch mode (kernel 2) at the four
          layers at batch 8 and 128; one FusedPreFn and one EngineFn
          gradient (deconv2, batch 128) against autograd of the plain
          versions; device, one-call and plain times, the bound, and as
          yardsticks conv_transpose2d (1, 2) and aten's convolution_backward
          (input grad for 4, raw-weight grad for 5).
  serve   DCGAN at its published widths through GanServeEngine (random
          weights from a seed): requests of 1, 3 and 8 images, then a run of
          more; checks the images against the plain-version generator, and
          that the kernel ran exactly 4 times per generate; images/s.
  train   DCGAN at its published widths, batch 128: 3 steps of make_gan_step
          with the generator on the CUDA kernels (cuda_chained, discriminator
          lax) and the same 3 steps on the plain versions (chained_ref) from
          the same params and batches; checks metrics, parameters, the
          non-finite flag, the step-1 gradients (each run's AdamW first
          moment) and 4/4/4 launches of the three kernels per step,
          with none of the backward ones in the discriminator's gradient
          pull; step ms, device ms, idle share, images/s, peak memory; the
          profile must show cuDNN convolutions (the check's own control).
  train_chained
          the same with the discriminator on the conv kernels too
          (conv_impl="cuda_chained") against chained_ref on both nets:
          launches per step (4/4/4 and 8/11/12) and per pull, the conv
          launches by layer, no F.conv2d call, and no cuDNN or aten
          convolution kernel in the profile.
  serve_per_layer
          the serve phase's requests through GanServeEngine(chained=False),
          once with "pallas_prepacked" (kernel 1) and once with
          "pallas_fused_pre_prepacked" (kernel 2): images against the
          per-layer plain generator (prepacked_ref), 4 launches of the
          variant's kernel per generate and none of kernel 3; images/s.
  train_per_layer
          the train phase's 3 steps with both nets per layer on the kernels
          (cuda_prepacked: kernels 1, 4, 5 and the conv corner's 3, 6, 7 in
          nhwc mode) against prepacked_ref on both: launches per step
          (4/4/4, none of the deconv corner's 3, 6, 7, and 8/11/12) and per
          pull, no F.conv2d call, no cuDNN or aten convolution kernel in the
          profile; step ms, idle share, images/s, peak memory.
  kernels one summary line per kernel (launches on each serving and training
          path, as that phase's run counted them, null for a phase that did
          not run; error, times, the least time the card could take; for the
          conv corner, the per-layer times weighted by the launches by layer
          that train_chained counted, and each kernel's device ms in that
          step's profile).
Each phase's seconds are printed after it.
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
SOURCE_BWD = "src/repro_torch/kernels/csrc/fused_engine_bwd.cu"
REPLACES_BWD_X = "src/repro/kernels/engine.py:1291"  # fused_engine_bwd_x's pallas_call
REPLACES_BWD_W = "src/repro/kernels/engine.py:1427"  # fused_engine_bwd_w's pallas_call
SOURCE_CONV = "src/repro_torch/kernels/csrc/conv_engine.cu"  # the three at the conv corner
SOURCE_DOM = "src/repro_torch/kernels/csrc/domain_engine.cu"  # kernels 1, 4, 5
REPLACES_DOM = "src/repro/kernels/engine.py:381"  # domain_engine's pallas_call
REPLACES_DOM_X = "src/repro/kernels/engine.py:995"  # domain_engine_bwd_x's pallas_call
REPLACES_DOM_W = "src/repro/kernels/engine.py:1085"  # domain_engine_bwd_w's pallas_call
REPLACES_SCRATCH = "src/repro/kernels/engine.py:739"  # fused_engine's scratch pallas_call (in SOURCE)
PHASES = ("kernel", "kernel_bwd", "kernel_conv", "kernel_domain", "serve", "train", "train_chained",
          "serve_per_layer", "train_per_layer")
TRAIN_BATCH = 128  # the DCGAN paper's mini-batch
# each row of the kernels line -> (its wrapper in repro_torch.kernels.engine,
# the attribute that counts its launches)
COUNTERS = {
    "fused_engine_epi": ("fused_engine", "launches"),
    "fused_engine_bwd_x": ("fused_engine_bwd_x", "launches"),
    "fused_engine_bwd_w": ("fused_engine_bwd_w", "launches"),
    "conv_engine_fwd": ("conv_fused_engine", "launches"),
    "conv_engine_bwd_x": ("conv_fused_engine_bwd_x", "launches"),
    "conv_engine_bwd_w": ("conv_fused_engine_bwd_w", "launches"),
    "domain_engine": ("domain_engine", "launches"),
    "domain_engine_bwd_x": ("domain_engine_bwd_x", "launches"),
    "domain_engine_bwd_w": ("domain_engine_bwd_w", "launches"),
    "fused_engine_scratch": ("fused_engine", "scratch_launches"),
}

# (fp32 FLOP/s outside the tensor cores, HBM bytes/s) from NVIDIA's data sheets
PEAKS = {
    "PCIe": (51.2e12, 2.0e12),
    "NVL": (60.0e12, 3.9e12),
    "SXM": (66.9e12, 3.35e12),
}


def zero_counts() -> None:
    """Every kernel's launch count to 0."""
    from repro_torch.kernels import engine

    for fn, attr in COUNTERS.values():
        setattr(getattr(engine, fn), attr, 0)


def read_counts() -> dict:
    """Every kernel's launch count, by its row in the kernels line."""
    from repro_torch.kernels import engine

    return {row: getattr(getattr(engine, fn), attr) for row, (fn, attr) in COUNTERS.items()}


def check_counts(where: str, got: dict, want: dict) -> None:
    """Fail unless the kernels in ``want`` launched as often as it says and
    every other kernel not at all."""
    if got != {row: want.get(row, 0) for row in COUNTERS}:
        fail(f"{where}: launches {got}, want {want} and 0 of every other kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def fold_adds(inv, groups, backward: bool = False) -> int:
    """Least adds per tile and output channel that the inverse transform
    needs, F(2,3): ``inv`` (C, 4) holds 0 or +-1, so each term is one add.
    Forward, per group of packed positions that share an output tile (a
    sub-filter; at the conv corner all C): the smaller of the direct sum
    through ``inv`` and A^T Y A on the 4x4 sum (24 adds; positions that
    share a Winograd position sum in the contraction's own chain).
    Backward, gw from g: the smaller of the direct rows and A g A^T (12
    adds, then fanned out)."""
    import numpy as np

    nz = np.asarray(inv) != 0
    total = 0
    for lo, hi in groups:
        terms = nz[lo:hi].sum(axis=1 if backward else 0)
        total += min(int(np.maximum(terms - 1, 0).sum()), 12 if backward else 24)
    return total


def overlap_adds(B: int, phases: int, N: int, ty: int, tx: int) -> int:
    """Adds of bwd_x's overlap sum: a cell's m x m values of each phase and
    channel gather one piece from each of the (up to 2 x 2) tiles whose
    4 x 4 windows cover it; ty*tx tiles give 4*ty*tx pieces to
    (ty+1)*(tx+1) cells."""
    return B * phases * 4 * N * max(0, 4 * ty * tx - (ty + 1) * (tx + 1))


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


def profiled_ms(fn, reps: int = 10, warmup: int = 3, name: str = "", what: str = ""):
    """One profiled run of ``reps`` back-to-back calls: (wall ms per call from
    CUDA events around the run, device ms per call from the profiler, device
    ms per call of the kernels whose name contains ``name``, device ms per
    call of each kernel by name).  The device time is taken inside the wall
    time it is compared with.  A session that records no device time (or
    none for ``name``) is run again, up to three sessions in all, and then
    fails: the tracer has been seen to drop a whole session's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
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
        if total > 0 and (named > 0 or not name):
            break
        emit({"note": f"profiler session {attempt + 1} recorded no device time",
              "for": what or name or "(all kernels)"})
    else:
        fail(f"the profiler recorded no device time for {what or name or 'any kernel'} in 3 sessions")
    by_kernel = {e.key: e.device_time_total / reps / 1e3 for e in evs if e.device_time_total > 0}
    return a.elapsed_time(b) / reps, total / reps / 1e3, named / reps / 1e3, by_kernel


def kernel_phase(torch, peaks):
    import torch.nn.functional as F

    from repro_torch.core.tdc import DeconvDims
    from repro_torch.kernels import engine, ops
    from repro_torch.kernels.ref import epilogue_apply_ref
    from repro_torch.models.gan import _cells_to_image

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
        got_img = _cells_to_image(got, (HO, HO), dims.padding) if emit_cells else got
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
        # channel), the post-PE inverse transform (fold_adds) and the
        # epilogue (affine + activation per output value)
        n_ops = (2 * T * C * N * M + 32 * T * N + T * M * fold_adds(packed.inv.cpu(), sub_slices)
                 + 3 * got.numel())
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


def _serve_params(torch):
    """DCGAN generator params from a seed, with non-trivial eval-mode
    batchnorm and stem bias, so a resident's folded affine is held to more
    than an identity."""
    from repro_torch.configs import DCGAN
    from repro_torch.models import gan as G

    params = G.generator_init(DCGAN, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    params["stem"]["b"] = 0.1 * torch.randn(params["stem"]["b"].shape, generator=g, device="cuda")
    for k, bn in params.items():
        if k.endswith("_bn"):
            c = bn["mean"].shape[0]
            bn["mean"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
            bn["var"] = 0.5 + torch.rand((c,), generator=g, device="cuda")
            bn["scale"] = 1.0 + 0.2 * torch.randn((c,), generator=g, device="cuda")
            bn["bias"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
    return params


def serve_rates(torch, eng, plain_cfg, kname):
    """Batch-1 and batch-8 generate times of ``eng`` (after its counted
    run): images/s, device ms and idle share from one profiled run, the
    kernel ``kname``'s device ms, the plain generator's time, and the
    submit-to-result latency (p50 and max of 20)."""
    from repro_torch.models import gan as G

    z1 = torch.randn((1, 100), generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    out = {}
    for b in (1, 8):
        z = z1.repeat(b, 1)
        gen_ms = wall_ms(lambda: eng.generate(z))
        prof_ms, dev_ms, kern_ms, _ = profiled_ms(lambda: eng.generate(z), name=kname)
        idle = 1.0 - dev_ms / prof_ms
        if idle < 0.0:
            fail(f"device time {dev_ms:.4f} ms exceeds the wall time {prof_ms:.4f} ms it was taken in")
        plain_ms = wall_ms(lambda: G.generator_apply(eng.params, plain_cfg, z), reps=10)
        lat = []
        for _ in range(20):
            t = time.perf_counter()
            eng.submit(z).result()
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t))
        out[b] = dict(generate_ms=gen_ms, images_per_s=1e3 * b / gen_ms, device_ms=dev_ms,
                      kernel_ms=kern_ms, profiled_generate_ms=prof_ms, device_idle_share=idle,
                      plain_generate_ms=plain_ms, request_latency_ms_p50=statistics.median(lat),
                      request_latency_ms_max=max(lat))
    return out


def serve_phase(torch, card):
    import dataclasses

    from repro_torch.configs import DCGAN
    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine

    t0 = time.perf_counter()
    eng = GanServeEngine(_serve_params(torch), DCGAN, batch=8, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = eng.archs[DCGAN.arch_id]
    g = torch.Generator(device="cuda").manual_seed(1)
    sizes_submit, sizes_run = (1, 3, 8), (2, 5, 8, 1, 4)
    zs = [torch.randn((b, DCGAN.z_dim), generator=g, device="cuda") for b in sizes_submit + sizes_run]

    # --- the main path: counts at 0 just before, read just after
    zero_counts()
    gen0 = res.generates
    futs = [eng.submit(z) for z in zs[: len(sizes_submit)]]
    outs = [f.result() for f in futs]
    outs += eng.run(zs[len(sizes_submit):])
    torch.cuda.synchronize()
    launches = read_counts()
    generates = res.generates - gen0
    if generates == 0:
        fail("no generate ran")
    check_counts("serve", launches, {"fused_engine_epi": 4 * generates})

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
          "generates": generates, "launches": launches["fused_engine_epi"], "max_abs_err_vs_plain": worst,
          "tol": worst_tol, "out_std": float(torch.cat([o.flatten() for o in outs]).std()),
          "setup_s": setup_s, "card": card})

    # --- throughput and latency (after the counted run)
    for b, rate in serve_rates(torch, eng, ref_cfg, "fused_epi_kernel").items():
        emit({"phase": "serve_rate", "batch": b, **rate, "card": card})
    return launches


def serve_per_layer_phase(torch, card):
    """DCGAN at its published widths through GanServeEngine(chained=False),
    once per per-layer engine: "pallas_prepacked" serves on kernel 1
    (cuda_prepacked, the unfused engine), "pallas_fused_pre_prepacked" on
    kernel 2 (cuda_fused_pre_prepacked, the fused pre-PE engine in scratch
    mode).  The same requests as ``serve``; images against the per-layer
    plain generator (prepacked_ref); exactly 4 launches of the variant's
    kernel per generate and none of kernel 3; images/s and latency.
    Returns every kernel's launches in the counted runs."""
    import dataclasses

    from repro_torch.configs import DCGAN
    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine

    params = _serve_params(torch)
    launches = dict.fromkeys(COUNTERS, 0)
    rates = {}
    for impl, served, key, kname in (
            ("pallas_prepacked", "cuda_prepacked", "domain_engine", "domain_fwd_kernel"),
            ("pallas_fused_pre_prepacked", "cuda_fused_pre_prepacked", "fused_engine_scratch", "fused_epi_kernel")):
        t0 = time.perf_counter()
        eng = GanServeEngine(params, dataclasses.replace(DCGAN, deconv_impl=impl), batch=8, device="cuda",
                             chained=False)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if eng.cfg.deconv_impl != served:
            fail(f"chained=False serves {impl} as {eng.cfg.deconv_impl}, want {served}")
        res = eng.archs[DCGAN.arch_id]
        g = torch.Generator(device="cuda").manual_seed(1)
        sizes_submit, sizes_run = (1, 3, 8), (2, 5, 8, 1, 4)
        zs = [torch.randn((b, DCGAN.z_dim), generator=g, device="cuda") for b in sizes_submit + sizes_run]

        # --- the main path: counts at 0 just before, read just after
        zero_counts()
        gen0 = res.generates
        futs = [eng.submit(z) for z in zs[: len(sizes_submit)]]
        outs = [f.result() for f in futs]
        outs += eng.run(zs[len(sizes_submit):])
        torch.cuda.synchronize()
        got = read_counts()
        generates = res.generates - gen0
        if generates == 0:
            fail(f"{impl}: no generate ran")
        check_counts(f"serve_per_layer {impl}", got, {key: 4 * generates})
        launches = {row: n + got[row] for row, n in launches.items()}

        plain_cfg = dataclasses.replace(eng.cfg, deconv_impl="prepacked_ref")
        worst, worst_tol = 0.0, 0.0
        with torch.inference_mode():
            for z, o in zip(zs, outs):
                if tuple(o.shape) != (z.shape[0], 64, 64, 3):
                    fail(f"{impl}: served shape {tuple(o.shape)} for a request of {z.shape[0]}")
                if not torch.isfinite(o).all() or o.abs().max().item() > 1.0:
                    fail(f"{impl}: served images not finite or outside [-1, 1]")
                want_img, _ = G.generator_apply(eng.params, plain_cfg, z)
                err = (o - want_img).abs().max().item()
                tol = 1e-4 * want_img.abs().max().item() + 1e-5
                if not err <= tol:
                    fail(f"{impl}: served image vs per-layer plain generator: max|err| {err:.3e} > {tol:.3e}")
                worst, worst_tol = max(worst, err), max(worst_tol, tol)
        emit({"phase": "serve_per_layer", "arch": "dcgan", "impl": impl, "served_as": served,
              "requests": len(zs), "images": sum(z.shape[0] for z in zs), "dispatch_log": eng.dispatch_log,
              "bucket_counts": eng.bucket_counts, "generates": generates,
              "launches": got, "max_abs_err_vs_plain": worst,
              "tol": worst_tol, "setup_s": setup_s, "card": card})
        rates[key] = serve_rates(torch, eng, plain_cfg, kname)
        for b, rate in rates[key].items():
            emit({"phase": "serve_per_layer_rate", "impl": impl, "batch": b, **rate, "card": card})
        del eng, res, outs
        torch.cuda.empty_cache()
    return dict(launches=launches, kernel_ms={k: r[8]["kernel_ms"] for k, r in rates.items()})


def _dcgan_train_shapes():
    """(name, dims, B, H, N, M, gy, emit_cells, act) of DCGAN's four deconv
    layers in a training step at batch 128; gy is the height of the cells
    the layer reads (the stem image's cells, then the previous layer's
    emitted cells, passed through)."""
    from repro_torch.core.tdc import DeconvDims

    K5 = DeconvDims(5, 2, 2, 1)
    B, rows, gy = TRAIN_BATCH, [], None
    for i, (H, N, M) in enumerate([(4, 1024, 512), (8, 512, 256), (16, 256, 128), (32, 128, 3)]):
        ty = -(-K5.j_extent(H) // 2)
        gy = ty + 1 if gy is None else gy
        last = i == 3
        rows.append((f"dcgan.deconv{i}", K5, B, H, N, M, gy, not last, "tanh" if last else "none"))
        gy = 2 * ty  # this layer's emitted cells: (B, ty*S, tx*S, 4, M)
    return rows


def kernel_bwd_phase(torch, peaks):
    from repro_torch.core.tdc import DeconvDims
    from repro_torch.kernels import engine, ops

    K4, K3, K2S3 = DeconvDims(4, 2, 1, 0), DeconvDims(3, 1, 1, 0), DeconvDims(2, 3, 0, 0)
    shapes = _dcgan_train_shapes() + [
        ("k4s2", K4, 8, 8, 256, 128, None, True, "leaky_relu"),
        ("k3s1", K3, 8, 32, 64, 3, None, False, "tanh"),
        ("k2s3", K2S3, 2, 8, 32, 16, None, False, "relu"),
    ]
    flops_peak, bytes_peak = peaks
    rows = []
    for i, (name, dims, B, H, N, M, gy, emit_cells, act) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        S, P = dims.stride, dims.padding
        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        C = len(pos_idx)
        ty = -(-dims.j_extent(H) // 2)
        gy = gy if gy is not None else ty + 1
        x = torch.randn((B, H, H, N), generator=g, device="cuda")
        w = 0.02 * torch.randn((dims.kernel, dims.kernel, N, M), generator=g, device="cuda")
        packed = ops.prepack(w, dims)
        cells = ops.cells_from_image(x, dims)
        if cells.shape[1] < gy:  # the pass-through cells of a chained layer are larger
            cells = torch.nn.functional.pad(cells, (0, 0, 0, 0, 0, gy - cells.shape[2], 0, gy - cells.shape[1]))
        cells = cells.contiguous()
        gs = torch.randn((B, ty, ty, S * S * 4, M), generator=g, device="cuda")
        geo = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=2, n=4, ty=ty, tx=ty, stride=S)
        run_x = lambda: engine.fused_engine_bwd_x(gs, packed.ww, packed.inv, gy=gy, gx=gy, **geo)  # noqa: E731
        run_w = lambda: engine.fused_engine_bwd_w(cells, gs, packed.inv, **geo)  # noqa: E731
        plain_x = lambda: engine.fused_engine_bwd_x_plain(gs, packed.ww, packed.inv, gy=gy, gx=gy, **geo)  # noqa: E731
        plain_w = lambda: engine.fused_engine_bwd_w_plain(cells, gs, packed.inv, **geo)  # noqa: E731
        errs = {}
        for key, run, plain in (("x", run_x, plain_x), ("w", run_w, plain_w)):
            got = run()
            torch.cuda.synchronize()
            want = plain()
            if tuple(got.shape) != tuple(want.shape):
                fail(f"bwd_{key} at {name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
            err = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-5
            if not err <= tol:
                fail(f"bwd_{key} kernel vs plain at {name}: max|err| {err:.3e} > {tol:.3e}")
            errs[key] = (err, tol)

        # the yardstick: aten's backward of this layer's conv_transpose2d
        HO = dims.out_size(H)
        xc = x.permute(0, 3, 1, 2).contiguous()
        wt = w.permute(2, 3, 0, 1).contiguous()
        go = torch.randn((B, M, HO, HO), generator=g, device="cuda")
        conv_bwd = lambda mask: torch.ops.aten.convolution_backward(  # noqa: E731
            go, xc, wt, None, [S, S], [P, P], [1, 1], True, [dims.output_padding] * 2, 1, mask)

        T = B * ty * ty
        # products, gw from g (fold_adds), the B-transform or its transpose
        # (32 adds per tile and channel), and for bwd_x the overlap sum
        common_ops = 2 * T * C * N * M + T * M * fold_adds(packed.inv.cpu(), sub_slices, True) + 32 * T * N
        dcells_n = B * gy * gy * 4 * N
        work = {
            "x": (4 * (gs.numel() + packed.ww.numel() + packed.inv.numel() + dcells_n),
                  common_ops + overlap_adds(B, 1, N, ty, ty)),
            "w": (4 * (cells.numel() + gs.numel() + packed.inv.numel() + C * N * M), common_ops),
        }
        for key, run, plain, kname, mask in (
                ("x", run_x, plain_x, "bwd_x_kernel", [True, False, False]),
                ("w", run_w, plain_w, "bwd_w_kernel", [False, True, False])):
            n_bytes, n_ops = work[key]
            t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
            ms = profiled_ms(run, reps=20, name=kname)[2]
            plain_ms = profiled_ms(plain, reps=5, warmup=1, what=f"plain bwd_{key} at {name}")[1]
            library_ms = profiled_ms(lambda: conv_bwd(mask), reps=20, what=f"convolution_backward at {name}")[1]
            row = dict(kernel=f"fused_engine_bwd_{key}", name=name, B=B, H_in=H, N=N, M=M, C=C, T=T, gy=gy,
                       max_abs_err=errs[key][0], tol=errs[key][1], ms=ms,
                       ms_wall=event_median_ms(run, reps=20), plain_ms=plain_ms,
                       plain_ms_wall=event_median_ms(plain, reps=5, warmup=1),
                       library_ms=library_ms, library_ms_wall=event_median_ms(lambda: conv_bwd(mask), reps=20),
                       library_note=("aten convolution_backward, input grad" if key == "x" else
                                     "aten convolution_backward, raw-weight grad (not the packed one)"),
                       bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=n_bytes, ops=n_ops, achieved_tflops=n_ops / (ms * 1e-3) / 1e12)
            if key == "x":
                row["plan"] = engine._bwd_x_plan(B, gy, gy, ty, ty, M, torch.cuda.current_device())
            else:
                row["splits"] = engine._bwd_w_plan(B, ty, ty, N, M, S, torch.cuda.current_device())[0]
            emit({"phase": "kernel_bwd", **row})
            rows.append(row)

        if name.startswith("dcgan."):  # the forward kernel at this training shape
            run_f = lambda: ops.winograd_deconv2d_cells(  # noqa: E731
                cells, packed, dims, (H, H), epilogue=act, emit_cells=emit_cells)
            plain_f = lambda: ops.winograd_deconv2d_cells(  # noqa: E731
                cells, packed, dims, (H, H), epilogue=act, emit_cells=emit_cells, backend="ref")
            got, want = run_f(), plain_f()
            err = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-5
            if not err <= tol:
                fail(f"forward kernel vs plain at {name} (batch {B}): max|err| {err:.3e} > {tol:.3e}")
            n_bytes = 4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + got.numel())
            n_ops = (2 * T * C * N * M + 32 * T * N + T * M * fold_adds(packed.inv.cpu(), sub_slices)
                     + 3 * got.numel())
            t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
            xc_ = x.permute(0, 3, 1, 2).contiguous()
            lib_f = lambda: torch.nn.functional.conv_transpose2d(  # noqa: E731
                xc_, wt, stride=S, padding=P, output_padding=dims.output_padding)
            ms = profiled_ms(run_f, reps=20, name="fused_epi_kernel")[2]
            row = dict(kernel="fused_engine_epi", name=name + ".train", B=B, H_in=H, N=N, M=M, C=C, T=T,
                       max_abs_err=err, tol=tol, ms=ms, ms_wall=event_median_ms(run_f, reps=20),
                       plain_ms=profiled_ms(plain_f, reps=5, warmup=1, what=f"plain forward at {name}")[1],
                       library_ms=profiled_ms(lib_f, reps=20, what=f"conv_transpose2d at {name}")[1],
                       library_note="conv_transpose2d without the epilogue",
                       bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=n_bytes, ops=n_ops, achieved_tflops=n_ops / (ms * 1e-3) / 1e12)
            emit({"phase": "kernel_bwd", **row})
            rows.append(row)
        del x, w, packed, cells, gs, go, xc
        torch.cuda.empty_cache()
    return rows


def kernel_domain_phase(torch, peaks):
    """Kernels 1, 4 and 5 (domain_engine.cu) against their plain versions at
    DCGAN's four generator layers at the training batch 128 and at a K4S2, a
    K3S1 and a K2S3 shape, kernel 1 also at the four layers at the serving
    batch 8; kernel 2 (fused_engine.cu, scratch mode) at the
    four layers at batch 8 and 128; one FusedPreFn and one EngineFn gradient
    against autograd of the plain versions.  Device, one-call and plain ms,
    the bound, and as yardsticks the layer's conv_transpose2d (kernels 1, 2)
    and aten's convolution_backward (input grad for 4, raw-weight grad for 5)."""
    import torch.nn.functional as F

    from repro_torch.core.tdc import DeconvDims
    from repro_torch.core.winograd_deconv import pad_input_for_tiles, transform_input_tiles
    from repro_torch.kernels import engine, ops

    K5, K4, K3, K2S3 = DeconvDims(5, 2, 2, 1), DeconvDims(4, 2, 1, 0), DeconvDims(3, 1, 1, 0), DeconvDims(2, 3, 0, 0)
    layers = [(f"dcgan.deconv{i}", K5, H, N, M)
              for i, (H, N, M) in enumerate([(4, 1024, 512), (8, 512, 256), (16, 256, 128), (32, 128, 3)])]
    all3 = ("fwd", "bwd_x", "bwd_w")
    shapes = [(n, d, TRAIN_BATCH, H, N, M, all3) for n, d, H, N, M in layers] + [
        (f"{n}.b8", d, 8, H, N, M, ("fwd",)) for n, d, H, N, M in layers] + [  # kernel 1 serves at batch 8
        ("k4s2", K4, 8, 8, 256, 128, all3), ("k3s1", K3, 8, 32, 64, 3, all3), ("k2s3", K2S3, 2, 8, 32, 16, all3)]
    scratch_shapes = [(n, d, B, H, N, M) for B in (8, TRAIN_BATCH) for n, d, H, N, M in layers]
    flops_peak, bytes_peak = peaks
    dev = torch.cuda.current_device()
    rows = []

    def held(what, got, want):
        if tuple(got.shape) != tuple(want.shape):
            fail(f"{what}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item() + 1e-5
        if not err <= tol:
            fail(f"{what} kernel vs plain: max|err| {err:.3e} > {tol:.3e}")
        return err, tol

    def layer_inputs(seed, dims, B, H, N, M):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((B, H, H, N), generator=g, device="cuda")
        w = 0.02 * torch.randn((dims.kernel, dims.kernel, N, M), generator=g, device="cuda")
        return g, x, w, ops.prepack(w, dims)

    def library_calls(g, x, w, dims, B, H, M):
        S, P = dims.stride, dims.padding
        HO = dims.out_size(H)
        xc = x.permute(0, 3, 1, 2).contiguous()
        wt = w.permute(2, 3, 0, 1).contiguous()
        go = torch.randn((B, M, HO, HO), generator=g, device="cuda")
        fwd = lambda: F.conv_transpose2d(xc, wt, stride=S, padding=P, output_padding=dims.output_padding)  # noqa: E731
        bwd = lambda mask: torch.ops.aten.convolution_backward(  # noqa: E731
            go, xc, wt, None, [S, S], [P, P], [1, 1], True, [dims.output_padding] * 2, 1, mask)
        return fwd, bwd

    def measure(kernel, name, B, H, N, M, C, T, run, plain, kname, lib, lib_note, n_bytes, n_ops, err, **extra):
        t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
        ms = profiled_ms(run, reps=20, name=kname)[2]
        row = dict(kernel=kernel, name=name, B=B, H_in=H, N=N, M=M, C=C, T=T, max_abs_err=err[0], tol=err[1],
                   ms=ms, ms_wall=event_median_ms(run, reps=20),
                   plain_ms=profiled_ms(plain, reps=5, warmup=1, what=f"plain {kernel} at {name}")[1],
                   library_ms=profiled_ms(lib, reps=20, what=f"library {kernel} at {name}")[1],
                   library_note=lib_note, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=n_bytes, ops=n_ops,
                   achieved_tflops=n_ops / (ms * 1e-3) / 1e12, **extra)
        emit({"phase": "kernel_domain", **row})
        rows.append(row)

    # --- kernels 1, 4, 5 on the transformed tiles
    for i, (name, dims, B, H, N, M, keys) in enumerate(shapes):
        g, x, w, packed = layer_inputs(400 + i, dims, B, H, N, M)
        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        C, S2 = len(pos_idx), dims.stride ** 2
        x_pad, (ty, tx) = pad_input_for_tiles(x, dims)
        T = B * ty * tx
        xw = transform_input_tiles(x_pad, (ty, tx)).reshape(T, 16, N).contiguous()
        gs = torch.randn((T, S2 * 4, M), generator=g, device="cuda")
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=4)
        runs = {k: v for k, v in {
            "fwd": (lambda: engine.domain_engine(xw, packed.ww, packed.inv, **kw),
                    lambda: engine.domain_engine_plain(xw, packed.ww, packed.inv, **kw)),
            "bwd_x": (lambda: engine.domain_engine_bwd_x(gs, packed.ww, packed.inv, n2=16, **kw),
                      lambda: engine.domain_engine_bwd_x_plain(gs, packed.ww, packed.inv, n2=16, **kw)),
            "bwd_w": (lambda: engine.domain_engine_bwd_w(xw, gs, packed.inv, **kw),
                      lambda: engine.domain_engine_bwd_w_plain(xw, gs, packed.inv, **kw)),
        }.items() if k in keys}
        errs = {}
        for key, (run, plain) in runs.items():
            got = run()
            torch.cuda.synchronize()
            errs[key] = held(f"domain_engine {key} at {name}", got, plain())
        lib_fwd, lib_bwd = library_calls(g, x, w, dims, B, H, M)
        inv_np = packed.inv.cpu()
        prod = 2 * T * C * N * M
        fold, gw = T * M * fold_adds(inv_np, sub_slices), T * M * fold_adds(inv_np, sub_slices, True)
        io = {"fwd": xw.numel() + packed.ww.numel() + T * S2 * 4 * M,
              "bwd_x": gs.numel() + packed.ww.numel() + xw.numel(),
              "bwd_w": xw.numel() + gs.numel() + packed.ww.numel()}
        libs = {"fwd": (lib_fwd, "conv_transpose2d (cuDNN), the whole layer"),
                "bwd_x": (lambda: lib_bwd([True, False, False]), "aten convolution_backward, input grad"),
                "bwd_w": (lambda: lib_bwd([False, True, False]),
                          "aten convolution_backward, raw-weight grad (not the packed one)")}
        knames = {"fwd": "domain_fwd_kernel", "bwd_x": "domain_bwd_x_kernel", "bwd_w": "domain_bwd_w_kernel"}
        for key, (run, plain) in runs.items():
            extra = {}
            if key == "fwd":
                extra["splits"] = engine._domain_plan("fwd", T, N, M, S2, dev)[0]
            elif key == "bwd_w":
                extra["splits"] = engine._domain_plan("bwd_w", T, N, M, S2, dev)[0]
            measure(f"domain_engine{'' if key == 'fwd' else '_' + key}", name, B, H, N, M, C, T, run, plain,
                    knames[key], *libs[key], 4 * (io[key] + packed.inv.numel()),
                    prod + (fold if key == "fwd" else gw), errs[key], **extra)
        del x, w, packed, xw, gs, x_pad
        torch.cuda.empty_cache()

    # --- kernel 2: the fused pre-PE engine in scratch mode
    for i, (name, dims, B, H, N, M) in enumerate(scratch_shapes):
        g, x, w, packed = layer_inputs(500 + i, dims, B, H, N, M)
        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        C = len(pos_idx)
        cells = ops.cells_from_image(x, dims)
        ty = tx = -(-dims.j_extent(H) // 2)
        T = B * ty * tx
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=2, n=4, ty=ty, tx=tx, stride=dims.stride,
                  padding=dims.padding, out_h=dims.out_size(H), out_w=dims.out_size(H), out_mode="scratch")
        run = lambda: engine.fused_engine(cells, packed.ww, packed.inv, **kw)  # noqa: E731
        plain = lambda: engine.fused_engine_plain(cells, packed.ww, packed.inv, **kw)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        err = held(f"fused_engine scratch at {name} batch {B}", got, plain())
        lib_fwd, _ = library_calls(g, x, w, dims, B, H, M)
        n_bytes = 4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + got.numel())
        n_ops = 2 * T * C * N * M + 32 * T * N + T * M * fold_adds(packed.inv.cpu(), sub_slices)
        measure("fused_engine_scratch", f"{name}.b{B}", B, H, N, M, C, T, run, plain, "fused_epi_kernel", lib_fwd,
                "conv_transpose2d (cuDNN), the whole layer", n_bytes, n_ops, err,
                splits=engine._plan(B, ty, tx, N, M, dims.stride, dev)[0])
        del x, w, packed, cells, got
        torch.cuda.empty_cache()

    # --- the two autograd Functions at a DCGAN training shape (deconv2,
    # batch 128) against autograd of the plain versions
    name, dims, H, N, M = layers[2]
    g, x0, w, packed = layer_inputs(600, dims, TRAIN_BATCH, H, N, M)
    go = torch.randn((TRAIN_BATCH, dims.out_size(H), dims.out_size(H), M), generator=g, device="cuda")
    for fuse_pre, fn in ((True, "FusedPreFn"), (False, "EngineFn")):
        grads = {}
        for backend in ("cuda", "ref"):
            x = x0.clone().requires_grad_(True)
            ww = packed.ww.clone().requires_grad_(True)
            y = ops.winograd_deconv2d_packed(x, ops.PackedDeconv(ww, packed.inv), dims, fuse_pre=fuse_pre,
                                             backend=backend)
            grads[backend] = torch.autograd.grad((y * go).sum(), (x, ww))
        torch.cuda.synchronize()
        ex = held(f"{fn} dx at {name}", grads["cuda"][0], grads["ref"][0])
        ew = held(f"{fn} dww at {name}", grads["cuda"][1], grads["ref"][1])
        emit({"phase": "kernel_domain", "grad_check": fn, "name": name, "B": TRAIN_BATCH,
              "dx_max_abs_err": ex[0], "dx_tol": ex[1], "dww_max_abs_err": ew[0], "dww_tol": ew[1]})
    del x0, w, packed, go, grads
    torch.cuda.empty_cache()
    return rows


def _dcgan_disc_shapes():
    """(name, K, S, B, H, W, N, M, emit_cells, act, affine) of DCGAN's four
    discriminator layers in a training step at batch 128 (conv0: bias and
    leaky_relu fused; conv1-3: bias fused, BN on the emitted cells)."""
    rows, H = [], 64
    for i, (N, M) in enumerate([(3, 64), (64, 128), (128, 256), (256, 512)]):
        rows.append((f"dcgan.conv{i}", 4, 2, TRAIN_BATCH, H, H, N, M, True,
                     "leaky_relu" if i == 0 else "none", False))
        H //= 2
    return rows


def _library_convs(names) -> list:
    """The names among ``names`` of cuDNN or aten convolution kernels."""
    pats = ("cudnn", "conv2d", "convolution", "implicit_gemm", "implicit_convolve", "dgrad", "wgrad", "fprop")
    return [k for k in names if any(p in k.lower() for p in pats)]


def kernel_conv_phase(torch, peaks):
    """The three conv-corner kernels against their plain versions at the
    DCGAN discriminator's training shapes and at an odd-extent K4S2, a K3S2
    and a K3S1 shape; device, one-call and plain ms, the bound, and the
    library yardsticks (conv2d plus the epilogue; aten convolution_backward
    for the input and for the raw weights)."""
    import torch.nn.functional as F

    from repro_torch.core import conv_same_dims
    from repro_torch.kernels import engine, ops
    from repro_torch.kernels.ref import epilogue_apply_ref

    shapes = _dcgan_disc_shapes() + [
        ("k4s2_odd", 4, 2, 8, 15, 13, 32, 48, False, "tanh", True),
        ("k3s2", 3, 2, 8, 16, 16, 36, 20, True, "relu", True),
        ("k3s1", 3, 1, 4, 16, 16, 3, 3, False, "leaky_relu", False),
    ]
    flops_peak, bytes_peak = peaks
    dev = torch.cuda.current_device()
    rows = []
    for i, (name, K, S, B, H, W, N, M, emit_cells, act, affine) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        cd = conv_same_dims(K, S, H)
        if conv_same_dims(K, S, W) != cd:
            fail(f"{name}: one ConvDims must serve both extents")
        x = torch.randn((B, H, W, N), generator=gen, device="cuda")
        w = (0.5 / (K * N**0.5)) * torch.randn((K, K, N, M), generator=gen, device="cuda")
        b = 0.1 * torch.randn((M,), generator=gen, device="cuda")
        scale = (1.0 + 0.1 * torch.randn((M,), generator=gen, device="cuda")) if affine else None
        packed = ops.prepack_conv(w, cd)
        cells = ops.conv_cells_from_image(x, cd)
        pos_idx = ops.conv_packed_layout(cd)[0]
        C = len(pos_idx)
        HO, WO = cd.out_size(H), cd.out_size(W)
        ty, tx = -(-HO // 2), -(-WO // 2)
        gy, gx = cells.shape[1], cells.shape[2]
        geo = dict(pos_idx=pos_idx, m=2, n=4, ty=ty, tx=tx, s2=S * S)
        fkw = dict(epilogue=act, scale=scale, bias=b, emit_cells=emit_cells)
        gs = torch.randn((B, ty, tx, 4, M), generator=gen, device="cuda")
        runs = {
            "fwd": (lambda: ops.winograd_conv2d_cells(cells, packed, cd, (H, W), **fkw),
                    lambda: ops.winograd_conv2d_cells(cells, packed, cd, (H, W), backend="ref", **fkw)),
            "bwd_x": (lambda: engine.conv_fused_engine_bwd_x(gs, packed.ww, packed.inv, gy=gy, gx=gx, **geo),
                      lambda: engine.conv_fused_engine_bwd_x_plain(gs, packed.ww, packed.inv, gy=gy, gx=gx, **geo)),
            "bwd_w": (lambda: engine.conv_fused_engine_bwd_w(cells, gs, packed.inv, **geo),
                      lambda: engine.conv_fused_engine_bwd_w_plain(cells, gs, packed.inv, **geo)),
        }
        errs = {}
        for key, (run, plain) in runs.items():
            got = run()
            torch.cuda.synchronize()
            want = plain()
            if tuple(got.shape) != tuple(want.shape):
                fail(f"conv {key} at {name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
            err = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-5
            if not err <= tol:
                fail(f"conv {key} kernel vs plain at {name}: max|err| {err:.3e} > {tol:.3e}")
            errs[key] = (err, tol, got.numel())

        # the yardsticks, which the port never calls: cuDNN through F.conv2d
        # on the SAME-padded NCHW image, aten's convolution_backward
        xc = x.permute(0, 3, 1, 2).contiguous()
        pads = (cd.padding, cd.pad_hi, cd.padding, cd.pad_hi)
        xp = F.pad(xc, pads)
        wt = w.permute(3, 2, 0, 1).contiguous()
        go = torch.randn((B, M, HO, WO), generator=gen, device="cuda")

        def lib_fwd():
            y = F.conv2d(xp, wt, stride=S).permute(0, 2, 3, 1)
            return epilogue_apply_ref(y, scale, b, act)

        got_img = runs["fwd"][0]()
        if emit_cells:
            got_img = got_img.reshape(B, ty, tx, 2, 2, M).permute(0, 1, 3, 2, 4, 5).reshape(
                B, 2 * ty, 2 * tx, M)[:, :HO, :WO]
        lib_img = lib_fwd()
        lib_err = (got_img - lib_img).abs().max().item()
        if not lib_err <= 1e-4 * lib_img.abs().max().item() + 1e-5:
            fail(f"conv kernel vs F.conv2d at {name}: max|err| {lib_err:.3e}")
        conv_bwd = lambda mask: torch.ops.aten.convolution_backward(  # noqa: E731
            go, xp, wt, None, [S, S], [0, 0], [1, 1], False, [0, 0], 1, mask)
        libs = {"fwd": (lib_fwd, "F.conv2d (cuDNN) + epilogue"),
                "bwd_x": (lambda: conv_bwd([True, False, False]), "aten convolution_backward, input grad"),
                "bwd_w": (lambda: conv_bwd([False, True, False]),
                          "aten convolution_backward, raw-weight grad (not the packed one)")}

        T = B * ty * tx
        # products, the B-transforms or their transposes (32 adds per tile,
        # phase and channel), the inverse transform or gw (fold_adds over
        # one group of all C positions), the epilogue (3 per output) or the
        # overlap sum
        prod = 2 * T * C * N * M + 32 * T * S * S * N
        inv_np = packed.inv.cpu()
        fold, gw = T * M * fold_adds(inv_np, [(0, C)]), T * M * fold_adds(inv_np, [(0, C)], True)
        dcells_n = B * gy * gx * S * S * 4 * N
        work = {
            "fwd": (4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + errs["fwd"][2]
                         + M * (2 if affine else 1)), prod + fold + 3 * errs["fwd"][2]),
            "bwd_x": (4 * (gs.numel() + packed.ww.numel() + packed.inv.numel() + dcells_n),
                      prod + gw + overlap_adds(B, S * S, N, ty, tx)),
            "bwd_w": (4 * (cells.numel() + gs.numel() + packed.inv.numel() + C * N * M), prod + gw),
        }
        knames = {"fwd": "conv_fwd_kernel", "bwd_x": "conv_bwd_x_kernel", "bwd_w": "conv_bwd_w_kernel"}
        for key, (run, plain) in runs.items():
            n_bytes, n_ops = work[key]
            t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
            lib, lib_note = libs[key]
            ms = profiled_ms(run, reps=20, name=knames[key])[2]
            row = dict(kernel=f"conv_engine_{key}", name=name, B=B, H_in=H, W_in=W, N=N, M=M, C=C, T=T,
                       out_mode="cells" if emit_cells else "nhwc", activation=act,
                       max_abs_err=errs[key][0], tol=errs[key][1], ms=ms, ms_wall=event_median_ms(run, reps=20),
                       plain_ms=profiled_ms(plain, reps=5, warmup=1, what=f"plain conv {key} at {name}")[1],
                       library_ms=profiled_ms(lib, reps=20, what=f"library conv {key} at {name}")[1],
                       library_note=lib_note, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=n_bytes, ops=n_ops,
                       achieved_tflops=n_ops / (ms * 1e-3) / 1e12)
            if key == "fwd":
                row["library_max_abs_err"] = lib_err
            elif key == "bwd_x":
                row["plan"] = engine._conv_bwd_x_plan(B, gy, gx, ty, tx, N, M, dev)
            else:
                row["splits"] = engine._conv_bwd_w_plan(B, ty, tx, N, M, S * S, dev)[0]
            emit({"phase": "kernel_conv", **row})
            rows.append(row)
        del x, w, packed, cells, gs, go, xc, xp
        torch.cuda.empty_cache()
    return rows


def _train_params(torch, cfg, seed):
    """Generator and discriminator params from ``seed`` with non-trivial
    batchnorm statistics and affines."""
    from repro_torch.models import gan as G

    gp = G.generator_init(cfg, seed=seed, device="cuda")
    dp = G.discriminator_init(cfg, seed=seed + 1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    for tree in (gp, dp):
        for k, bn in tree.items():
            if k.endswith("_bn"):
                c = bn["mean"].shape[0]
                bn["mean"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
                bn["var"] = 0.5 + torch.rand((c,), generator=g, device="cuda")
                bn["scale"] = 1.0 + 0.2 * torch.randn((c,), generator=g, device="cuda")
                bn["bias"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
    return gp, dp


def check_first_moments(first_k, first_r) -> float:
    """Step-1 gradients of both nets, as each run's AdamW took them (the first
    moment after one step from zero is (1 - b1) * g): per leaf within 1e-3 of
    the leaf's largest value, a bias right before a batch-statistics BN
    (exact gradient zero, fp32 noise in both) within 1e-5 of the net's
    largest.  Returns the worst error as a share of its tolerance."""
    worst = 0.0
    for net, mk, mr in zip(("G", "D"), first_k, first_r):
        top = max(float(v.abs().max()) for leaf in mr.values() for v in leaf.values())
        for k, leaf in mr.items():
            for kk, want in leaf.items():
                exact_zero = kk == "b" and f"{k}_bn" in mr
                tol = 1e-5 * top if exact_zero else 1e-3 * float(want.abs().max())
                err = float((mk[k][kk] - want).abs().max())
                if not err <= tol:
                    fail(f"step-1 AdamW first moment of {net}.{k}.{kk}: kernels vs plain {err:.3e} > {tol:.3e}")
                worst = max(worst, err / tol if tol > 0 else 0.0)
    return worst


def train_phase(torch, card, conv_impl="lax", deconv_impl="cuda_chained"):
    """3 DCGAN train steps at batch 128 with the generator on the kernels
    (``deconv_impl`` "cuda_chained": kernels 3, 6, 7; "cuda_prepacked", per
    layer: kernels 1, 4, 5) and the discriminator on ``conv_impl`` ("lax":
    cuDNN; "cuda_chained" or per-layer "cuda_prepacked": the conv kernels)
    against the same 3 on the plain versions; launch counts per step and
    per gradient pull; then step time, idle share, peak memory and a check
    on the convolution kernels the step runs."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch import data as D
    from repro_torch.configs import DCGAN
    from repro_torch.kernels import engine
    from repro_torch.models import gan as G
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepSettings, make_gan_step
    from repro_torch.train import trainer as T
    from repro_torch.tree import tree_leaves

    chained = conv_impl != "lax"  # the discriminator on the conv kernels
    per_layer_g = deconv_impl != "cuda_chained"
    tag = "train_per_layer" if per_layer_g else "train_chained" if chained else "train"
    names = ["fused_engine_epi", "fused_engine_bwd_x", "fused_engine_bwd_w"]  # rows of the kernels line
    want_step, want_g, want_d = (4, 4, 4), (0, 4, 4), (0, 0, 0)
    if per_layer_g:  # kernels 1, 4, 5 instead, and none of 3, 6, 7 at the deconv corner
        names = ["domain_engine", "domain_engine_bwd_x", "domain_engine_bwd_w"] + names
        want_step, want_g, want_d = (4, 4, 4, 0, 0, 0), (0, 4, 4, 0, 0, 0), (0,) * 6
    cfg = dataclasses.replace(DCGAN, deconv_impl=deconv_impl, conv_impl=conv_impl)
    # the conv wrappers' launches by discriminator layer, told apart by the
    # channels of their first argument (cells: N; bwd_x's g: M)
    conv_wrappers = {}
    if chained:
        names += ["conv_engine_fwd", "conv_engine_bwd_x", "conv_engine_bwd_w"]
        want_step += (8, 11, 12)
        want_g, want_d = want_g + (0, 4, 4), want_d + (0, 7, 8)
        chans_in, chans_out = (cfg.img_ch, *G.disc_channels(cfg)[:-1]), G.disc_channels(cfg)
        conv_wrappers = {"conv_fused_engine": ("fwd", chans_in), "conv_fused_engine_bwd_x": ("bwd_x", chans_out),
                         "conv_fused_engine_bwd_w": ("bwd_w", chans_in)}
    per_layer = {key: [0] * len(chans) for key, chans in conv_wrappers.values()}
    counts = lambda: tuple(read_counts()[n] for n in names)  # noqa: E731

    class ByLayer:
        """Stands in for a conv wrapper in ``engine`` during the counted run.
        The wrapper counts its launch through its module-level name, so
        ``launches`` passes through to the real function's count."""

        def __init__(self, key, chans, fn):
            self.key, self.chans, self.fn = key, chans, fn

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, value):
            self.fn.launches = value

        def __call__(self, *a, **k):
            before = self.fn.launches
            out = self.fn(*a, **k)
            per_layer[self.key][self.chans.index(a[0].shape[-1])] += self.fn.launches - before
            return out

    ref_of = {"cuda_chained": "chained_ref", "cuda_prepacked": "prepacked_ref", "lax": "lax"}
    plain = dict(deconv_impl=ref_of[deconv_impl], conv_impl=ref_of[conv_impl])
    settings = StepSettings()
    B, steps = TRAIN_BATCH, 3
    t0 = time.perf_counter()
    gp0, dp0 = _train_params(torch, cfg, seed=0)
    batches = [(D.latent_batch(0, s, B, cfg.z_dim, device="cuda"), D.gan_batch(0, s, B, cfg.img_hw, device="cuda"))
               for s in range(steps)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # record the kernels' launches around each gradient pull of the step,
    # and every F.conv2d call
    pulls, conv2d_calls = [], [0]
    real_grads, real_conv2d = T._grads, F.conv2d

    def recording_grads(loss, tree, *, retain_graph):
        before = counts()
        out = real_grads(loss, tree, retain_graph=retain_graph)
        torch.cuda.synchronize()
        pulls.append(tuple(a - b for a, b in zip(counts(), before)))
        return out

    def counting_conv2d(*a, **k):
        conv2d_calls[0] += 1
        return real_conv2d(*a, **k)

    def run(**impls):
        step = make_gan_step(cfg, settings=dataclasses.replace(settings, **impls))
        gp, dp = gp0, dp0
        g_opt, d_opt = adamw_init(gp), adamw_init(dp)
        per_step, metrics, first = [], [], None
        for z, real in batches:
            before = counts()
            gp, dp, g_opt, d_opt, m = step(gp, dp, g_opt, d_opt, z, real)
            torch.cuda.synchronize()
            per_step.append(tuple(a - b for a, b in zip(counts(), before)))
            metrics.append({k: float(v) for k, v in m.items()})
            first = first or (g_opt.m, d_opt.m)
        return gp, dp, per_step, metrics, first

    # --- the main path: counts at 0 just before, read just after
    zero_counts()
    real_conv = {name: getattr(engine, name) for name in conv_wrappers}
    T._grads, F.conv2d = recording_grads, counting_conv2d
    for name, (key, chans) in conv_wrappers.items():
        setattr(engine, name, ByLayer(key, chans, real_conv[name]))
    try:
        gp_k, dp_k, per_step, m_k, first_k = run(deconv_impl=deconv_impl, conv_impl=conv_impl)
    finally:
        T._grads, F.conv2d = real_grads, real_conv2d
        for name, fn in real_conv.items():
            setattr(engine, name, fn)
    launches = read_counts()
    check_counts(tag, launches, {n: steps * w for n, w in zip(names, want_step)})
    for key, n in per_layer.items():
        if sum(n) != launches["conv_engine_" + key]:
            fail(f"conv {key} launches by layer {n} do not add up to {launches}")
    if any(ps != want_step for ps in per_step):
        fail(f"kernel launches per train step ({', '.join(names)}) {per_step}, want {want_step} each")
    g_pulls, d_pulls = pulls[0::2], pulls[1::2]
    if any(p != want_g for p in g_pulls) or any(p != want_d for p in d_pulls):
        fail(f"launches per gradient pull: G {g_pulls}, D {d_pulls}; want {want_g} and {want_d}")
    if chained and conv2d_calls[0]:
        fail(f"the {conv_impl} discriminator called F.conv2d {conv2d_calls[0]} times")
    if not chained and conv2d_calls[0] != 8 * steps:
        fail(f"the lax step called F.conv2d {conv2d_calls[0]} times, want 8 per step")
    gp_r, dp_r, _, m_r, first_r = run(**plain)
    moment_share = check_first_moments(first_k, first_r)
    del first_k, first_r  # not held into the peak-memory reading below

    worst = {}
    for s, (a, b) in enumerate(zip(m_k, m_r)):
        if a["nonfinite"] or b["nonfinite"]:
            fail(f"step {s}: non-finite metrics {a} / {b}")
        for key in ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm"):
            rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-12)
            worst[key] = max(worst.get(key, 0.0), rel)
            if not rel <= 1e-3:
                fail(f"step {s} {key}: kernels {a[key]!r} vs plain {b[key]!r} (rel {rel:.2e} > 1e-3)")
    bound = 6 * settings.lr
    leaves_k = tree_leaves(gp_k) + tree_leaves(dp_k)
    if not all(bool(torch.isfinite(x).all()) for x in leaves_k):
        fail("non-finite parameters after the kernel steps")
    param_err = max((x - y).abs().max().item() for x, y in zip(leaves_k, tree_leaves(gp_r) + tree_leaves(dp_r)))
    if not param_err <= bound:
        fail(f"parameters after {steps} steps differ by {param_err:.3e} > 6*lr = {bound:.1e}")
    emit({"phase": tag, "arch": "dcgan", "batch": B, "steps": steps, "deconv_impl": deconv_impl,
          "conv_impl": conv_impl, "kernels": names, "launches_per_step": per_step,
          "launches_per_pull": {"G": g_pulls, "D": d_pulls}, "f_conv2d_calls": conv2d_calls[0],
          "conv_launches_per_step_by_layer": {k: [v / steps for v in n] for k, n in per_layer.items()},
          "step1_first_moment_err_share_of_tol": moment_share,
          "metrics": m_k, "metrics_plain": m_r, "plain_impls": plain, "max_rel_err_metrics": worst,
          "max_abs_err_params": param_err, "param_bound": bound, "setup_s": setup_s, "card": card})

    # --- speed (after the counted run)
    step = make_gan_step(cfg, settings=settings)
    state = [gp_k, dp_k, adamw_init(gp_k), adamw_init(dp_k)]
    z, real = batches[0]

    def one():
        state[:] = step(*state, z, real)[:4]

    torch.cuda.reset_peak_memory_stats()
    step_ms = wall_ms(one, reps=5, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    prof_ms, dev_ms, _, by_kernel = profiled_ms(one, reps=5, warmup=1)
    idle = 1.0 - dev_ms / prof_ms
    if idle < 0.0:
        fail(f"device time {dev_ms:.4f} ms exceeds the wall time {prof_ms:.4f} ms it was taken in")
    library_convs = _library_convs(by_kernel)
    if chained and library_convs:
        fail(f"cuDNN or aten convolution kernels in the {tag} step's profile: {library_convs}")
    if not chained and not library_convs:  # the check's own control: the lax step does run cuDNN
        fail(f"no convolution kernel found in the lax step's profile: {sorted(by_kernel)[:20]}")
    ours = {k: v for k, v in by_kernel.items() if any(n in k for n in (
        "fused_epi_kernel", "bwd_x_kernel", "bwd_w_kernel", "conv_fwd_kernel", "domain_fwd_kernel"))}
    plain_step = make_gan_step(cfg, settings=dataclasses.replace(settings, **plain))
    pstate = [gp_k, dp_k, adamw_init(gp_k), adamw_init(dp_k)]

    def one_plain():
        pstate[:] = plain_step(*pstate, z, real)[:4]

    plain_step_ms = wall_ms(one_plain, reps=3, warmup=1)
    emit({"phase": tag + "_rate", "batch": B, "step_ms": step_ms, "images_per_s": 1e3 * B / step_ms,
          "profiled_step_ms": prof_ms, "device_ms": dev_ms, "device_idle_share": idle,
          "engine_kernels_ms": sum(ours.values()), "engine_kernels": ours,
          "library_conv_kernels_ms": {k: by_kernel[k] for k in library_convs},
          "top_kernels": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]),
          "plain_step_ms": plain_step_ms, "max_memory_allocated": peak, "card": card})
    return dict(launches=launches, per_layer={k: [v / steps for v in n] for k, n in per_layer.items()},
                step_kernels=by_kernel)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (default: all)")
    phases = ap.parse_args(argv).phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")

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

    def timed(name, fn, default):
        """Run phase ``name`` if it was asked for, and print its seconds."""
        if name not in phases:
            return default
        t = time.perf_counter()
        out = fn()
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t})
        return out

    rows = timed("kernel", lambda: kernel_phase(torch, peaks), [])
    bwd_rows = timed("kernel_bwd", lambda: kernel_bwd_phase(torch, peaks), [])
    conv_rows = timed("kernel_conv", lambda: kernel_conv_phase(torch, peaks), [])
    domain_rows = timed("kernel_domain", lambda: kernel_domain_phase(torch, peaks), [])
    serve_launches = timed("serve", lambda: serve_phase(torch, smi), None)
    train = timed("train", lambda: train_phase(torch, smi), {})
    chained = timed("train_chained", lambda: train_phase(torch, smi, "cuda_chained"), {})
    serve_pl = timed("serve_per_layer", lambda: serve_per_layer_phase(torch, smi), {})
    per_layer = timed("train_per_layer", lambda: train_phase(torch, smi, "cuda_prepacked", "cuda_prepacked"), {})
    # each path's launches of every kernel, counted in its run (None: not run)
    path_launches = {"serve": serve_launches, "train": train.get("launches"),
                     "train_chained": chained.get("launches"), "serve_per_layer": serve_pl.get("launches"),
                     "train_per_layer": per_layer.get("launches")}

    def step_device_ms(kname, run=None):
        """Device ms per step of ``kname``'s instantiations in a train
        step's profile (the chained step's by default; None without it)."""
        run = chained if run is None else run
        if not run:
            return None
        return sum(v for k, v in run["step_kernels"].items() if f"::{kname}<" in k)

    def summary(krows, weights=None, batch=None):
        """Sums over the DCGAN layer rows (one generate, or one train step;
        those at ``batch`` if given), layer i counted ``weights[i]`` times
        (once each by default)."""
        main_rows = [r for r in krows if r["name"].startswith("dcgan.") and (batch is None or r["B"] == batch)]
        wts = weights or (1,) * len(main_rows)
        tot = {k: sum(w * r[k] for w, r in zip(wts, main_rows)) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_bytes = sum(w * 1e3 * r["bytes"] / peaks[1] for w, r in zip(wts, main_rows))
        by_ops = sum(w * 1e3 * r["ops"] / peaks[0] for w, r in zip(wts, main_rows))
        return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                    bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=tot["library_ms"],
                    max_abs_err=max((r["max_abs_err"] for r in krows), default=None),
                    shapes=[{k: r[k] for k in ("name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                               "max_abs_err")} for r in krows])

    def by_path(row):
        paths = {path: None if n is None else n[row] for path, n in path_launches.items()}
        return dict(launches=sum(n for n in paths.values() if n), launches_by_path=paths)

    fwd_train = [r for r in bwd_rows if r["kernel"] == "fused_engine_epi"]
    line = [{"name": "fused_engine_epi", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
             "corner": "deconv", **by_path("fused_engine_epi"),
             # ms ... library_ms: one DCGAN generate at batch 8, the four layer shapes summed
             **summary(rows), "step_profile_ms": step_device_ms("fused_epi_kernel")}]
    if fwd_train:
        line[0]["train_step_batch128"] = {k: v for k, v in summary(fwd_train).items() if k != "shapes"}
    for key, replaces in (("x", REPLACES_BWD_X), ("w", REPLACES_BWD_W)):
        krows = [r for r in bwd_rows if r["kernel"] == f"fused_engine_bwd_{key}"]
        line.append({"name": f"fused_engine_bwd_{key}", "route": "cuda", "source": SOURCE_BWD,
                     "replaces": replaces, "corner": "deconv", **by_path(f"fused_engine_bwd_{key}"),
                     # ms ... library_ms: one DCGAN train step at batch 128, the four layer shapes summed
                     **summary(krows), "step_profile_ms": step_device_ms(f"bwd_{key}_kernel")})
    for key, replaces in (("fwd", REPLACES), ("bwd_x", REPLACES_BWD_X), ("bwd_w", REPLACES_BWD_W)):
        krows = [r for r in conv_rows if r["kernel"] == f"conv_engine_{key}"]
        weights = chained["per_layer"][key] if chained else None
        line.append({"name": f"conv_engine_{key}", "route": "cuda", "source": SOURCE_CONV,
                     "replaces": replaces + " (conv corner, via src/repro/kernels/winograd_deconv.py)",
                     "corner": "conv", **by_path(f"conv_engine_{key}"),
                     # ms ... library_ms: one DCGAN train step at batch 128, each discriminator layer
                     # counted as often as the train_chained run launched it per step (per_pass: once
                     # each, when that phase did not run)
                     **summary(krows, weights), "launches_per_step_by_layer": weights,
                     "step_profile_ms": step_device_ms(f"conv_{key}_kernel"),
                     "per_pass": {k: v for k, v in summary(krows).items() if k != "shapes"}})
    for key, replaces in (("", REPLACES_DOM), ("_bwd_x", REPLACES_DOM_X), ("_bwd_w", REPLACES_DOM_W)):
        krows = [r for r in domain_rows if r["kernel"] == f"domain_engine{key}"]
        kname = f"domain_{key[1:] or 'fwd'}_kernel"
        line.append({"name": f"domain_engine{key}", "route": "cuda", "source": SOURCE_DOM, "replaces": replaces,
                     "corner": "deconv", **by_path(f"domain_engine{key}"),
                     # ms ... library_ms: one DCGAN train step at batch 128, the four layer shapes summed
                     **summary(krows, batch=TRAIN_BATCH), "step_profile_ms": step_device_ms(kname, per_layer)})
        if not key:  # kernel 1 also serves: one DCGAN generate at batch 8
            line[-1]["serve_batch8"] = {k: v for k, v in summary(krows, batch=8).items() if k != "shapes"}
            line[-1]["serve_batch8_profile_ms"] = serve_pl.get("kernel_ms", {}).get("domain_engine")
    scratch = [r for r in domain_rows if r["kernel"] == "fused_engine_scratch"]
    line.append({"name": "fused_engine_scratch", "route": "cuda", "source": SOURCE, "replaces": REPLACES_SCRATCH,
                 "corner": "deconv", **by_path("fused_engine_scratch"),
                 # ms ... library_ms: one DCGAN generate at batch 8, the four layer shapes summed
                 **summary(scratch, batch=8),
                 "train_step_batch128": {k: v for k, v in summary(scratch, batch=TRAIN_BATCH).items()
                                         if k != "shapes"},
                 "serve_batch8_profile_ms": serve_pl.get("kernel_ms", {}).get("fused_engine_scratch")})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
