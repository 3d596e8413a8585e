"""Production launcher (the reference's ``launch/train.py``): the mesh,
the sharded step (``launch.steps``) and a checkpointed loop, one process a
rank.  On the card cluster it runs the full configs on the production mesh;
``--smoke`` runs the same code on a (1, 1) mesh with a reduced config.  The
step, its specs and the checkpoint layout are the same in both.

  torchrun --nproc-per-node 256 -m repro_torch.launch.train --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.train --arch llama3-8b --smoke [--device cpu] [--ckpt-dir DIR]
  python -m repro_torch.launch.train --arch dcgan --smoke

A process started by ``torchrun`` joins the process group its environment
describes (NCCL on the card, gloo on the CPU); a lone process is a world
of 1 on gloo.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from .. import data as D
from ..configs import REGISTRY, SHAPES, get_config, smoke_config
from ..configs.base import GANConfig
from ..models import gan as G
from ..models import lm as LM
from ..optim import OptState, adamw_init
from ..parallel import sharding as SH
from ..train import checkpoint as C
from .mesh import make_mesh, make_production_mesh
from .steps import build_gan_step, build_lm_step

__all__ = ["main"]


def _join(device: str) -> bool:
    """Join the process group (torchrun's environment, or a world of 1);
    True when this call created it."""
    if dist.is_initialized():
        return False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return True


def _blocks(tree, specs, mesh):
    return SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), tree, specs)


def _save(directory: str, step: int, params, opt, pspecs, mesh) -> None:
    """Rank 0 writes the gathered tree (the reference's layout: {"p", "o"})."""
    full = lambda tree: SH.map_specs(lambda t, sp: SH.gather(t, sp, mesh), tree, pspecs)  # noqa: E731
    tree = {"p": full(params), "o": OptState(opt.step, full(opt.m), full(opt.v))}
    if dist.get_rank() == 0:
        C.save_checkpoint(directory, step, tree)
    dist.barrier()


def _gan(cfg: GANConfig, mesh, args) -> None:
    """The GAN archs through ``build_gan_step`` (the mesh step), fp32: the
    port's Winograd kernels take fp32 operands."""
    fn, (gp_s, dp_s, _, _, z_s, real_s), meta = build_gan_step(cfg, mesh)
    gsp, dsp, gosp, dosp = meta["specs"]
    zspec, rspec = meta["batch_specs"]
    gp = _blocks(G.generator_init(cfg, seed=0, device=args.device), gsp, mesh)
    dp = _blocks(G.discriminator_init(cfg, seed=1, device=args.device), dsp, mesh)
    go, do = adamw_init(gp), adamw_init(dp)
    for s in range(args.steps):
        z = SH.block_of(D.latent_batch(0, s, z_s.shape[0], cfg.z_dim, device=args.device), zspec, mesh)
        real = SH.block_of(D.gan_batch(0, s, real_s.shape[0], cfg.img_hw, device=args.device), rspec, mesh)
        gp, dp, go, do, m = fn(gp, dp, go, do, z, real)
        print(f"step {s}: g={float(m['g_loss']):.4f} d={float(m['d_loss']):.4f}", flush=True)


def _lm_batch(cfg, shape, s: int, device):
    B, T = shape.global_batch, shape.seq_len
    tokens = D.lm_batch(0, s, B, T, cfg.vocab, device=device)
    if cfg.frontend != "stub_embeds":
        return tokens
    batch = {"embeds": D.embed_batch(0, s, B, T, cfg.d_model, device=device).to(torch.bfloat16),
             "labels": tokens["labels"]}
    if cfg.mrope_sections:
        batch["positions"] = torch.arange(T, device=device)[None, :, None].expand(B, T, 3)
    return batch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="reduced config + (1, 1) mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    created = _join(args.device)
    try:
        mesh_shape = ((1, 1), ("data", "model")) if args.smoke else make_production_mesh(multi_pod=args.multi_pod)
        mesh = make_mesh(*mesh_shape, device=args.device)
        cfg = get_config(args.arch)
        if isinstance(cfg, GANConfig):
            _gan(cfg, mesh, args)
        else:
            _lm(cfg, mesh, args)
        print("done", flush=True)
    finally:
        if created:
            dist.destroy_process_group()


def _lm(cfg, mesh, args) -> None:
    shape = SHAPES[args.shape]
    if args.smoke:
        cfg = smoke_config(args.arch)
        shape = dataclasses.replace(shape, seq_len=64, global_batch=4)
    fn, (params_s, opt_s, _), meta = build_lm_step(cfg, shape, mesh)
    if meta["fallbacks"]:
        print("sharding fallbacks:", *meta["fallbacks"], sep="\n  ")
    pspecs = SH.lm_param_specs(cfg, mesh)[0]
    bspecs = SH.lm_batch_specs(cfg, shape, mesh)
    params = _blocks(LM.lm_init(cfg, seed=0, device=args.device, dtype=torch.bfloat16), pspecs, mesh)
    opt = adamw_init(params)
    start = 0
    if args.ckpt_dir and (last := C.latest_step(args.ckpt_dir)) is not None:
        placed = SH.named(mesh, {"p": pspecs, "o": SH.opt_specs(pspecs)})
        tree = C.restore_checkpoint(args.ckpt_dir, last, {"p": params_s, "o": opt_s}, shardings=placed)
        params, opt, start = tree["p"], tree["o"], last
        print(f"resumed from step {start}")
    t0 = time.time()
    for s in range(start, args.steps):
        batch = {k: SH.block_of(v, bspecs[k], mesh) for k, v in _lm_batch(cfg, shape, s, args.device).items()}
        params, opt, loss = fn(params, opt, batch)
        print(f"step {s}: loss={float(loss):.4f} ({time.time() - t0:.1f}s elapsed)", flush=True)
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            _save(args.ckpt_dir, s + 1, params, opt, pspecs, mesh)


if __name__ == "__main__":
    main()
