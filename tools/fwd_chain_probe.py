#!/usr/bin/env python3
"""What the length of kernel 1's tensor-core chain (``kFwdChain`` in
csrc/domain_engine.cu: the stages of 32 channels n whose products add in the
wgmma accumulator before they fold into the outputs in fp32) does to the
kernel's error and time, and to the per-layer DCGAN train step's agreement
with its plain version, over seeds.

    python3 tools/fwd_chain_probe.py [--chains 1,2,4,8,16,32] [--seeds 0,1,2,3,4] [--cuda-cores]

For each chain the script copies the package's csrc/ to
build/fwd_chain/<chain>/csrc with the constant rewritten and builds it
there, every variant in a process of its own, all started together.  Then,
one variant after the other in a process of its own:

* at DCGAN's deconv0-2 at batch 128 (the smoke's ``kernel_domain`` inputs),
  kernel 1 on the tensor cores against the plain version: the error share
  (max|err| over 1e-4 max|plain| + 1e-5) and the device ms of the forward
  and its weight pack;
* for each seed, the smoke's ``train_per_layer`` comparison: 3 DCGAN train
  steps at batch 128 with both nets per layer (``cuda_prepacked``) against
  the same 3 on the plain versions (``prepacked_ref``), the plain run's
  step 1 on the kernel run's side of each activation kink.  Seed 0 is the
  smoke's data; seed k draws the parameters from seed k and the batches
  from data seed k.

``--cuda-cores`` adds the variant ``cuda_cores``: the source as it is, with
kernel 1 held on its CUDA-core instantiation (fp32 FMAs, no chain) at every
layer, as before the tensor cores.

Prints one JSON line per variant for the layers and one per (variant, seed)
for the train steps (per step the relative error of g_loss, d_loss,
g_grad_norm and d_grad_norm, which the smoke holds to 1e-3, the plain run's
values, and the step-1 first moments' error share of their tolerance), then
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONSTANT = "constexpr int kFwdChain = {};"
CUDA_CORES = "cuda_cores"
LAYERS = [(4, 1024, 512), (8, 512, 256), (16, 256, 128)]  # DCGAN's deconv0-2: H, N, M
METRICS = ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm")


def _variant_csrc(variant: str) -> Path:
    """The csrc/ a variant builds from: a copy with the chain rewritten, or
    the package's own for ``cuda_cores``."""
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    if variant == CUDA_CORES:
        return src
    dst = ROOT / "build" / "fwd_chain" / variant / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    cu = dst / "domain_engine.cu"
    text = cu.read_text()
    found = re.findall(r"constexpr int kFwdChain = \d+;", text)
    if len(found) != 1:
        raise SystemExit(f"fwd_chain_probe: {len(found)} kFwdChain constants in {cu}")
    cu.write_text(text.replace(found[0], CONSTANT.format(int(variant))))
    return dst


def _layers(torch, conf: int) -> dict:
    """Kernel 1 at deconv0-2 at batch 128 on instantiation ``conf``: error
    share and device ms by layer."""
    import chip_smoke as cs
    from repro_torch.core.tdc import DeconvDims
    from repro_torch.core.winograd_deconv import pad_input_for_tiles, transform_input_tiles
    from repro_torch.kernels import engine, ops

    dims, out = DeconvDims(5, 2, 2, 1), {}
    names = cs.DOMAIN_FWD_MMA if conf == 1 else ("domain_fwd_kernel",)
    for i, (H, N, M) in enumerate(LAYERS):
        g = torch.Generator(device="cuda").manual_seed(400 + i)  # the smoke's kernel_domain inputs
        x = torch.randn((cs.TRAIN_BATCH, H, H, N), generator=g, device="cuda")
        w = 0.02 * torch.randn((dims.kernel, dims.kernel, N, M), generator=g, device="cuda")
        packed = ops.prepack(w, dims)
        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        x_pad, (ty, tx) = pad_input_for_tiles(x, dims)
        xw = transform_input_tiles(x_pad, (ty, tx)).reshape(-1, 16, N).contiguous()
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=4)
        name = engine.INSTANTIATIONS["domain_engine"][conf]
        run = lambda: engine.domain_engine(xw, packed.ww, packed.inv, conf=name, **kw)  # noqa: E731
        want = engine.domain_engine_plain(xw, packed.ww, packed.inv, **kw)
        err = (run() - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item() + 1e-5
        out[f"deconv{i}"] = dict(err_share=err / tol, ms=cs.profiled_ms(run, reps=10, name=names)[2])
        del x, w, packed, xw, want, x_pad
        torch.cuda.empty_cache()
    return out


def _train(torch, seed: int) -> dict:
    """The smoke's train_per_layer comparison on ``seed``'s data."""
    import chip_smoke as cs
    from repro_torch import data as D
    from repro_torch.configs import DCGAN
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepSettings, make_gan_step

    cfg = dataclasses.replace(DCGAN, deconv_impl="cuda_prepacked", conv_impl="cuda_prepacked")
    gp0, dp0 = cs._train_params(torch, cfg, seed=seed)
    B = cs.TRAIN_BATCH
    batches = [(D.latent_batch(seed, s, B, cfg.z_dim, device="cuda"), D.gan_batch(seed, s, B, cfg.img_hw, device="cuda"))
               for s in range(3)]

    def run(impl, sides):
        step = make_gan_step(cfg, settings=dataclasses.replace(StepSettings(), deconv_impl=impl, conv_impl=impl))
        gp, dp = gp0, dp0
        g_opt, d_opt = adamw_init(gp), adamw_init(dp)
        metrics, first = [], None
        for s, (z, real) in enumerate(batches):
            with sides() if s == 0 else contextlib.nullcontext():
                gp, dp, g_opt, d_opt, m = step(gp, dp, g_opt, d_opt, z, real)
            torch.cuda.synchronize()
            metrics.append({k: float(v) for k, v in m.items()})
            first = first or (g_opt.m, d_opt.m)
        return metrics, first

    k_kinks, p_kinks = [], []
    m_k, first_k = run("cuda_prepacked", lambda: cs.kink_sides(k_kinks))
    m_r, first_r = run("prepacked_ref", lambda: cs.kink_sides(p_kinks, follow=k_kinks))
    share = max(err / tol if tol > 0 else 0.0 for _, err, tol in cs.first_moment_errs(first_k, first_r))
    rel = {k: [abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(m_k, m_r)] for k in METRICS}
    out = dict(seed=seed, rel=rel, plain={k: [b[k] for b in m_r] for k in METRICS},
               step1_first_moment_err_share_of_tol=share,
               passes_1e3=all(r <= 1e-3 for v in rel.values() for r in v))
    del gp0, dp0, batches, first_k, first_r, k_kinks, p_kinks
    torch.cuda.empty_cache()
    return out


def _child(variant: str, csrc: Path, seeds: list[int], build_only: bool) -> int:
    import torch

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build, engine

    if variant != CUDA_CORES:
        _build.CSRC, _build.BUILD_DIR = csrc, csrc.parent / "lib"
    _build.load_library()
    if build_only:
        return 0
    conf = 0 if variant == CUDA_CORES else 1
    if variant == CUDA_CORES:  # every layer's kernel 1 on the CUDA cores
        fwd = engine._domain_fwd  # the CUDA-core instantiation (INSTANTIATIONS["domain_engine"][0]) for every call
        engine._domain_fwd = lambda *a, want=None, **k: fwd(*a, want=(0, -1), **k)
    print(json.dumps({"variant": variant, "layers": _layers(torch, conf)}), flush=True)
    for seed in seeds:
        print(json.dumps({"variant": variant, **_train(torch, seed)}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", default="1,2,4,8,16,32", help="comma-separated chain lengths (stages)")
    ap.add_argument("--seeds", default="0,1,2,3,4", help="comma-separated seeds of the train comparison")
    ap.add_argument("--cuda-cores", action="store_true", help="add the CUDA-core kernel as a variant")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--csrc", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.child:
        return _child(args.child, args.csrc, seeds, args.build_only)

    import torch

    if not torch.cuda.is_available():
        print("fwd_chain_probe: no CUDA device", file=sys.stderr)
        return 2
    variants = [str(int(c)) for c in args.chains.split(",")] + ([CUDA_CORES] if args.cuda_cores else [])
    me = [sys.executable, str(Path(__file__).resolve())]
    csrcs = {v: _variant_csrc(v) for v in variants}
    builds = {v: subprocess.Popen([*me, "--child", v, "--csrc", str(csrcs[v]), "--build-only"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for v in variants}
    for v, p in builds.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            print(f"fwd_chain_probe: variant {v} failed to build ({p.returncode}):\n{log[-4000:]}", file=sys.stderr)
            return 1
    for v in variants:
        rc = subprocess.run([*me, "--child", v, "--csrc", str(csrcs[v]), "--seeds", args.seeds]).returncode
        if rc != 0:
            print(f"fwd_chain_probe: variant {v} failed ({rc})", file=sys.stderr)
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
