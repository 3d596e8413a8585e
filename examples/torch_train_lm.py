"""End-to-end LM training with the PyTorch port: any of the ten LM archs at
its reduced ``smoke_config``, AdamW with the gradient clipped at norm 1.0,
checkpoints that resume (the full configs run through
``python -m repro_torch.launch.train`` on a mesh).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --arch llama3-8b --steps 50 [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import data as D
from repro_torch.configs import LMS, smoke_config
from repro_torch.models import lm
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train import checkpoint as C
from repro_torch.tree import tree_leaves, tree_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(LMS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    params = lm.lm_init(cfg, seed=0, device=args.device)
    opt = adamw_init(params)
    print(f"{args.arch}: reduced config, {sum(t.numel() for t in tree_leaves(params)) / 1e6:.2f}M params")

    def step(params, opt, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = lm.train_loss(leaves, cfg, batch, q_chunk=32, loss_chunk=32)
        grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(tree_leaves(leaves), grads))
        params, opt, _ = adamw_update(params, tree_map(lambda _: next(it), params), opt, lr=3e-4, max_grad_norm=1.0)
        return params, opt, loss.detach()

    start = 0
    if args.ckpt_dir and (last := C.latest_step(args.ckpt_dir)) is not None:
        tree = C.restore_checkpoint(args.ckpt_dir, last, {"params": params, "opt": opt}, device=args.device)
        params, opt, start = tree["params"], tree["opt"], last
        print(f"resumed from step {start}")

    t0 = time.time()
    for s in range(start, args.steps):
        if cfg.frontend == "stub_embeds":
            pos = torch.arange(args.seq, device=args.device)
            batch = {"embeds": D.embed_batch(0, s, args.batch, args.seq, cfg.d_model, device=args.device),
                     "labels": D.lm_batch(0, s, args.batch, args.seq, cfg.vocab, device=args.device)["labels"],
                     "positions": pos[None, :, None].expand(args.batch, args.seq, 3) if cfg.mrope_sections
                     else pos[None].expand(args.batch, args.seq)}
        else:
            batch = D.lm_batch(0, s, args.batch, args.seq, cfg.vocab, device=args.device)
        params, opt, loss = step(params, opt, batch)
        if (s + 1) % 10 == 0 or s + 1 == args.steps:
            print(f"step {s + 1:4d}  loss {float(loss):.4f}  ({(time.time() - t0) / (s + 1 - start):.2f}s/step)")
        if args.ckpt_dir and (s + 1) % 25 == 0:
            C.save_checkpoint(args.ckpt_dir, s + 1, {"params": params, "opt": opt})
    print("done")


if __name__ == "__main__":
    main()
