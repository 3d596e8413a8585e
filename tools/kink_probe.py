#!/usr/bin/env python3
"""Where the kernels' and the plain versions' activation inputs part across a
kink (relu, leaky_relu) on the card, and what that does to the gradients.

    python3 tools/kink_probe.py dcgan [--config per_layer|chained]
    python3 tools/kink_probe.py audio [--seeds 0,1,2,3] [--tree DIR]

``dcgan`` runs one full-width DCGAN train step (batch 128, the smoke's
parameters and first batch) on the kernels and once on the plain versions,
records every input of the discriminator's leaky_relu
(``models.layers.leaky_relu``: the per-layer trunk calls it after each conv
and batchnorm), and prints for each call the largest difference over the
input's standard deviation and the inputs whose sign differs between the two
runs (their values in both).  A sign that differs takes the other slope of
the kink, so that element's gradient differs by 0.8 of the gradient flowing
into it: the train phases of chip_smoke.py hold the step-1 gradients to 1e-3
of each leaf's largest, which one such element in a batchnorm channel of
2048 values can move past.  ``--config chained`` runs the chained trunk,
which fuses the activation into its kernels' epilogues and records only the
calls outside them.

``audio`` runs the audio decoder's gradient check of chip_smoke.py (width
64, batch 16, 4096 frames, the gradient of sum(y^2) on impl "cuda" against
impl "ref") for each seed (seed 0 is the smoke's data: the parameters from
seed 0, then the biases and the latent from generator seed 1; seed k draws
them the same way from seed k and generator seed 1 + k), records the inputs
of the decoder's relu layers in both runs, and prints for each seed: per
relu layer the inputs whose sign differs and the largest difference over
the input's standard deviation; the gradient's error share of its tolerance
(max over leaves of max|err| / (1e-3 max|ref|), the smoke's); and that
share again with the kernels' run taking the plain run's relu masks (each
relu layer's output x * (x_ref > 0)), which removes exactly the kink
flips.  ``--tree DIR`` imports the package and the smoke from another
checkout (an older commit unpacked with ``git archive``), so two commits
can be read in one call.

Prints one JSON line per call or seed, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _dcgan(torch, config: str) -> int:
    import chip_smoke
    from repro_torch import data as D
    from repro_torch.configs import DCGAN
    from repro_torch.models import layers
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepSettings, make_gan_step

    inputs, leaky = [], layers.leaky_relu

    def recording(x, slope=0.2):
        inputs.append(x.detach().clone())
        return leaky(x, slope)

    layers.leaky_relu = recording
    impls = {"per_layer": ("cuda_prepacked", "prepacked_ref"), "chained": ("cuda_chained", "chained_ref")}[config]

    def step_inputs(impl):
        cfg = dataclasses.replace(DCGAN, deconv_impl=impl, conv_impl=impl)
        gp, dp = chip_smoke._train_params(torch, cfg, seed=0)
        z = D.latent_batch(0, 0, chip_smoke.TRAIN_BATCH, cfg.z_dim, device="cuda")
        real = D.gan_batch(0, 0, chip_smoke.TRAIN_BATCH, cfg.img_hw, device="cuda")
        inputs.clear()
        make_gan_step(cfg, settings=StepSettings())(gp, dp, adamw_init(gp), adamw_init(dp), z, real)
        torch.cuda.synchronize()
        return list(inputs)

    kernels, plain = step_inputs(impls[0]), step_inputs(impls[1])
    if len(kernels) != len(plain):
        print(f"kink_probe: {len(kernels)} leaky_relu calls on the kernels, {len(plain)} on the plain versions",
              file=sys.stderr)
        return 1
    for i, (a, b) in enumerate(zip(kernels, plain)):
        print(json.dumps({"call": i, "shape": list(a.shape), **_parting(a, b)}), flush=True)
    return 0


def _parting(a, b) -> dict:
    """How the kernels' activation inputs ``a`` part from the plain ``b``."""
    parts = (a > 0) != (b > 0)
    std = float(b.std())
    return {"std": std, "max_abs_diff_over_std": float((a - b).abs().max()) / std, "sign_differs": int(parts.sum()),
            "parted": [{"index": j, "kernels": float(a[tuple(j)]), "plain": float(b[tuple(j)])}
                       for j in parts.nonzero()[:8].tolist()]}


def _audio(torch, seeds: list[int]) -> int:
    import chip_smoke
    from repro_torch.configs.musicgen_medium import audio_decoder
    from repro_torch.models import gan as G

    specs = audio_decoder(chip_smoke.AUDIO_WIDTH)
    relu = G._AUDIO_ACTS["relu"]
    inputs, masks = [], []

    def recording(x):
        inputs.append(x.detach().clone())
        return relu(x)

    def plain_masked(x):  # the plain run's mask for this call, in order
        inputs.append(x.detach().clone())
        return x * masks[len(inputs) - 1]

    def grads(params, x, impl, act):
        p = {k: {kk: v.detach().clone().requires_grad_(True) for kk, v in leaf.items()} for k, leaf in params.items()}
        inputs.clear()
        G._AUDIO_ACTS["relu"] = act
        try:
            y = G.audio_decoder_apply(p, specs, x, impl=impl)
            keys = [(k, kk) for k, leaf in p.items() for kk in leaf]
            g = dict(zip(keys, torch.autograd.grad((y**2).sum(), [p[k][kk] for k, kk in keys])))
        finally:
            G._AUDIO_ACTS["relu"] = relu
        torch.cuda.synchronize()
        return g, list(inputs)

    def share(got, want):
        by_leaf = {f"{k}.{kk}": float((got[k, kk] - w).abs().max()) / (1e-3 * float(w.abs().max()))
                   for (k, kk), w in want.items()}
        return max(by_leaf.values()), by_leaf

    for seed in seeds:
        params = G.audio_decoder_init(specs, seed=seed, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1 + seed)
        for leaf in params.values():  # the smoke's non-zero biases
            leaf["b"] = 0.1 * torch.randn(leaf["b"].shape, generator=gen, device="cuda")
        x = torch.randn((chip_smoke.AUDIO_BATCH, chip_smoke.AUDIO_FRAMES, specs[0].c_in), generator=gen,
                        device="cuda")
        g_ref, ref_in = grads(params, x, "ref", recording)
        g_k, k_in = grads(params, x, "cuda", recording)
        masks[:] = [(v > 0).to(v.dtype) for v in ref_in]
        g_km, _ = grads(params, x, "cuda", plain_masked)
        (s, by_leaf), (s_masked, _) = share(g_k, g_ref), share(g_km, g_ref)
        print(json.dumps({"seed": seed, "relu_layers": [{"shape": list(a.shape), **_parting(a, b)}
                                                        for a, b in zip(k_in, ref_in)],
                          "grad_err_share_of_tol": s, "grad_err_share_by_leaf": by_leaf,
                          "grad_err_share_with_plain_masks": s_masked}), flush=True)
        del params, x, g_ref, g_k, g_km, ref_in, k_in
        masks.clear()
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", choices=("dcgan", "audio"))
    ap.add_argument("--config", choices=("per_layer", "chained"), default="per_layer")
    ap.add_argument("--seeds", default="0", help="audio: comma-separated seeds")
    ap.add_argument("--tree", type=Path, default=ROOT, help="the checkout whose package and smoke to import")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kink_probe: no CUDA device", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.model == "dcgan":
        rc = _dcgan(torch, args.config)
    else:
        rc = _audio(torch, [int(s) for s in args.seeds.split(",")])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    return rc


if __name__ == "__main__":
    sys.exit(main())
