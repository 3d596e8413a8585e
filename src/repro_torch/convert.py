"""Weights across the package boundary: reference-layout numpy trees in,
port params out.  This is the one way weights cross between the two
packages; the port never reads the reference's arrays any other way."""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import GANConfig

__all__ = ["generator_params_from_numpy"]


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
    out = {}
    for key, leaves in tree.items():
        out[key] = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device) for k, v in leaves.items()}
    for i, d in enumerate(cfg.deconvs):
        wd = out[f"deconv{i}"]
        if "w" in wd and tuple(wd["w"].shape) != (d.dims.kernel, d.dims.kernel, d.c_in, d.c_out):
            raise ValueError(f"deconv{i} raw weights {tuple(wd['w'].shape)} do not match {d}")
        if "ww" in wd and tuple(wd["ww"].shape[1:]) != (d.c_in, d.c_out):
            raise ValueError(f"deconv{i} packed weights {tuple(wd['ww'].shape)} do not match {d}")
    return out
