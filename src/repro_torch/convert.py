"""Weights across the package boundary: reference-layout numpy trees in,
port params out.  This is the one way weights cross between the two
packages; the port never reads the reference's arrays any other way."""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import GANConfig

__all__ = ["generator_params_from_numpy", "discriminator_params_from_numpy"]


def _to_torch(tree, device):
    return {key: {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device) for k, v in leaves.items()}
            for key, leaves in tree.items()}


def generator_params_from_numpy(tree, cfg: GANConfig, device="cuda"):
    """A generator param tree of numpy arrays in the reference's layout
    (``stem``, ``stem_bn``, ``enc{i}``, ``deconv{i}: {"w"}`` raw or
    ``{"ww"}`` packed, ``deconv{i}_bn``) -> the same tree of fp32 tensors
    on ``device``.  Keys and shapes are checked against ``cfg``."""
    want = set()
    if cfg.z_dim:
        want |= {"stem", "stem_bn"}
    for i, e in enumerate(cfg.encoder):
        want.add(f"enc{i}")
        if e.norm == "batch":
            want.add(f"enc{i}_bn")
    for i, d in enumerate(cfg.deconvs):
        want.add(f"deconv{i}")
        if d.norm == "batch":
            want.add(f"deconv{i}_bn")
    if set(tree) != want:
        raise ValueError(f"param keys {sorted(tree)} != {sorted(want)} for {cfg.arch_id}")
    out = _to_torch(tree, device)
    for i, d in enumerate(cfg.deconvs):
        wd = out[f"deconv{i}"]
        if "w" in wd and tuple(wd["w"].shape) != (d.dims.kernel, d.dims.kernel, d.c_in, d.c_out):
            raise ValueError(f"deconv{i} raw weights {tuple(wd['w'].shape)} do not match {d}")
        if "ww" in wd and tuple(wd["ww"].shape[1:]) != (d.c_in, d.c_out):
            raise ValueError(f"deconv{i} packed weights {tuple(wd['ww'].shape)} do not match {d}")
    return out


def discriminator_params_from_numpy(tree, cfg: GANConfig, device="cuda"):
    """A discriminator param tree of numpy arrays in the reference's layout
    (``conv{i}: {"w", "b"}`` raw K4 weights or ``{"ww", "b"}`` packed ones,
    ``conv{i}_bn`` after every conv but the first, ``head``) -> the same
    tree of fp32 tensors on ``device``.  Keys and shapes are checked against
    ``cfg``; packed ``ww`` against the layer's ``conv_packed_layout``."""
    from .kernels.ops import conv_packed_layout
    from .models.gan import DISC_KERNEL, disc_channels, disc_conv_dims

    chans = [cfg.img_ch, *disc_channels(cfg)]
    want = {"head"} | {f"conv{i}" for i in range(len(chans) - 1)} | {
        f"conv{i}_bn" for i in range(1, len(chans) - 1)}
    if set(tree) != want:
        raise ValueError(f"param keys {sorted(tree)} != {sorted(want)} for {cfg.arch_id}'s discriminator")
    out = _to_torch(tree, device)
    for i, cd in enumerate(disc_conv_dims(cfg)):
        wd = out[f"conv{i}"]
        if set(wd) == {"w", "b"}:
            want = (DISC_KERNEL, DISC_KERNEL, chans[i], chans[i + 1])
        elif set(wd) == {"ww", "b"}:
            want = (len(conv_packed_layout(cd)[0]), chans[i], chans[i + 1])
        else:
            raise ValueError(f"conv{i} holds {sorted(wd)}; the port's discriminator takes {{'w', 'b'}} or "
                             f"{{'ww', 'b'}}")
        got = tuple(wd["w" if "w" in wd else "ww"].shape)
        if got != want or tuple(wd["b"].shape) != (chans[i + 1],):
            raise ValueError(f"conv{i} shapes {got} / {tuple(wd['b'].shape)} do not match {want} / "
                             f"({chans[i + 1]},)")
    final_hw = cfg.img_hw // 2 ** (len(chans) - 1)
    if tuple(out["head"]["w"].shape) != (final_hw**2 * chans[-1], 1):
        raise ValueError(f"head weights {tuple(out['head']['w'].shape)} do not match {cfg.arch_id}")
    return out
