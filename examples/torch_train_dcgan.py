"""End-to-end training with the PyTorch port: DCGAN (the paper's flagship
workload) on synthetic data with checkpointing, on the card by default.

The default impls are the chained engine on both nets (``cuda_chained``:
the full adversarial step, both nets and both gradients, on the Winograd
kernels; CPU tensors take their plain versions).  The default model is a
width-reduced DCGAN; --full uses the published 1024-512-256-128 generator.

A checkpoint directory written by the JAX package's examples/train_dcgan.py
resumes here (and the other way round) when both runs use the same widths
and the same weight layout: ``pallas_chained`` there is ``cuda_chained``
here (packed weights), ``ref`` / ``lax`` raw ones.

Run:  PYTHONPATH=src python examples/torch_train_dcgan.py --steps 200 [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import DCGAN
from repro_torch.models.gan import CONV_IMPLS, IMPLS
from repro_torch.train import TrainHooks, train_gan


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="full-width DCGAN")
    ap.add_argument("--width-div", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_dcgan_ckpt"))
    ap.add_argument("--impl", default="auto", choices=["auto", *IMPLS],
                    help="generator impl (auto: cuda_chained)")
    ap.add_argument("--disc-impl", default="auto", choices=["auto", *CONV_IMPLS],
                    help="discriminator impl (auto: cuda_chained)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    impl = "cuda_chained" if args.impl == "auto" else args.impl
    disc_impl = "cuda_chained" if args.disc_impl == "auto" else args.disc_impl
    cfg = DCGAN
    if not args.full:
        d = args.width_div
        cfg = dataclasses.replace(
            cfg,
            stem_ch=DCGAN.stem_ch // d,
            deconvs=tuple(
                dataclasses.replace(s, c_in=max(3, s.c_in // d), c_out=(3 if s.c_out == 3 else s.c_out // d))
                for s in DCGAN.deconvs
            ),
            disc_channels=tuple(max(8, c // d) for c in DCGAN.disc_channels),
        )
    cfg = dataclasses.replace(cfg, deconv_impl=impl, conv_impl=disc_impl)

    out = train_gan(
        cfg,
        steps=args.steps,
        batch=args.batch,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        log_every=10,
        device=args.device,
        hooks=TrainHooks(on_step=lambda s, m: print(f"step {s:5d}  g_loss {m['g_loss']:.4f}  d_loss {m['d_loss']:.4f}")),
    )
    print(f"finished at step {out['final_step']}" + (" (preempted)" if out["preempted"] else ""))


if __name__ == "__main__":
    main()
