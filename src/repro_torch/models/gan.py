"""GAN generator on the Winograd DeConv engine (eval mode).

The generator's deconv trunk runs as one cell-to-cell pipeline: every layer
is one call of the epilogue-fused engine, with eval-mode batchnorm folded
into a per-channel scale and bias and the activation applied in the
engine's finalize.  Where the cell layouts line up (``ops.chain_aligned``)
a layer emits the next layer's cells directly; otherwise it emits NHWC
pixels and the next layer re-lays them out.

Impl names (``cfg.deconv_impl``):
  * ``"cuda_chained"``: the CUDA engine for CUDA tensors, its plain version
    for CPU tensors;
  * ``"chained_ref"``: the plain version on every device.
``serve_impl`` maps the reference's impl names (``ref``, ``prepacked_ref``,
``pallas*``, ...) onto ``"cuda_chained"``; they all compute this function.
Training mode is not in this slice.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import GANConfig
from ..core.tdc import DeconvDims
from ..kernels import ops as kops
from . import layers as L

Params = dict[str, Any]

__all__ = [
    "IMPLS", "uses_chained", "serve_impl", "generator_init", "prepack_generator",
    "fold_eval_bn", "generator_apply",
]

# chained impl -> winograd_deconv2d_cells kwargs
_CHAINED_KW: dict[str, dict] = {
    "cuda_chained": dict(backend="cuda"),
    "chained_ref": dict(backend="ref"),
}
IMPLS = tuple(_CHAINED_KW)

_TRAINING_LATER = (
    "training mode (batch-stat BN and the backward kernels) comes with the "
    "training slice of the port; this slice serves eval mode only"
)


def uses_chained(impl: str) -> bool:
    """True if ``impl`` is one of the port's chained pipelines."""
    return impl in _CHAINED_KW


def serve_impl(impl: str) -> str:
    """The serving impl for ``impl``: the port's own names pass through, and
    every reference name maps to ``"cuda_chained"``."""
    return impl if impl in _CHAINED_KW else "cuda_chained"


def generator_init(
    cfg: GANConfig, *, seed: int = 0, device="cuda", dtype=torch.float32
) -> Params:
    """Random generator params from ``seed``, drawn on ``device``.  Deconv
    weights are raw (K, K, N, M) ``{"w"}`` unless ``cfg.deconv_impl`` is a
    chained impl, which keeps packed (C, N, M) ``{"ww"}``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p: Params = {}
    if cfg.z_dim:
        p["stem"] = L.linear_init(gen, cfg.z_dim, cfg.seed_hw**2 * cfg.stem_ch, dtype)
        p["stem_bn"] = L.batchnorm_init(cfg.stem_ch, device, dtype)
    for i, e in enumerate(cfg.encoder):
        p[f"enc{i}"] = L.conv2d_init(gen, e.kernel, e.c_in, e.c_out, dtype)
        if e.norm == "batch":
            p[f"enc{i}_bn"] = L.batchnorm_init(e.c_out, device, dtype)
    for i, d in enumerate(cfg.deconvs):
        w = L.normal_init(gen, (d.dims.kernel, d.dims.kernel, d.c_in, d.c_out), 0.02, dtype)
        p[f"deconv{i}"] = {"ww": kops.prepack(w, d.dims).ww} if uses_chained(cfg.deconv_impl) else {"w": w}
        if d.norm == "batch":
            p[f"deconv{i}_bn"] = L.batchnorm_init(d.c_out, device, dtype)
    return p


def prepack_generator(params: Params, cfg: GANConfig) -> Params:
    """Raw deconv weights -> packed (C, N, M) ``{"ww"}``, once.  Packed
    leaves pass through untouched."""
    out = dict(params)
    for i, d in enumerate(cfg.deconvs):
        wd = params[f"deconv{i}"]
        if "w" in wd:
            out[f"deconv{i}"] = {"ww": kops.prepack(wd["w"], d.dims).ww}
    return out


def _packed_of(wd: Params, dims: DeconvDims) -> kops.PackedDeconv:
    if "ww" not in wd:
        raise ValueError("chained impls take packed {'ww'} weights: call prepack_generator first")
    return kops.PackedDeconv(wd["ww"], kops.packed_inv(dims, wd["ww"].device))


def _bn_eval_affine(bn: Params, eps: float = 1e-5):
    """Fold eval-mode batchnorm into a per-channel affine y = a*x + b."""
    a = bn["scale"].float() * torch.rsqrt(bn["var"] + eps)
    b = bn["bias"].float() - bn["mean"] * a
    return a.contiguous(), b.contiguous()


def fold_eval_bn(p: Params, cfg: GANConfig) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Every eval-mode batchnorm of the stem and the deconv trunk folded into
    its per-channel (scale, bias).  A server folds once per resident and
    passes the result to ``generator_apply``, which otherwise folds per call."""
    names = (["stem_bn"] if cfg.z_dim else []) + [
        f"deconv{i}_bn" for i, d in enumerate(cfg.deconvs) if d.norm == "batch"
    ]
    return {name: _bn_eval_affine(p[name]) for name in names}


def _chained_deconv_trunk(
    p: Params, cfg: GANConfig, h: torch.Tensor, folded, *, training: bool = False
) -> tuple[torch.Tensor, Params]:
    """The deconv trunk as one engine-domain pipeline (eval mode): one
    fused-engine call per layer.  Returns (image, bn_stats)."""
    if training:
        raise NotImplementedError(_TRAINING_LATER)
    kw = _CHAINED_KW[cfg.deconv_impl]
    new_stats: Params = {}
    hw = (h.shape[1], h.shape[2])
    cells = kops.cells_from_image(h, cfg.deconvs[0].dims)
    img = None
    for i, d in enumerate(cfg.deconvs):
        packed = _packed_of(p[f"deconv{i}"], d.dims)
        nxt = cfg.deconvs[i + 1].dims if i + 1 < len(cfg.deconvs) else None
        out_hw = (d.dims.out_size(hw[0]), d.dims.out_size(hw[1]))
        scale = bias = None
        if d.norm == "batch":
            bn = p[f"deconv{i}_bn"]
            scale, bias = folded[f"deconv{i}_bn"]
            new_stats[f"deconv{i}_bn"] = {"mean": bn["mean"], "var": bn["var"]}
        if nxt is not None and kops.chain_aligned(d.dims, nxt):
            emitted = kops.winograd_deconv2d_cells(
                cells, packed, d.dims, hw, epilogue=d.act, scale=scale, bias=bias,
                emit_cells=True, **kw,
            )
            cells = kops.cells_to_next(emitted, d.dims, nxt, out_hw)
        else:  # last layer, or a misaligned hop: NHWC pixels out
            img = kops.winograd_deconv2d_cells(
                cells, packed, d.dims, hw, epilogue=d.act, scale=scale, bias=bias, **kw,
            )
            if nxt is not None:
                cells = kops.cells_from_image(img, nxt)
        hw = out_hw
    return img, new_stats


def generator_apply(
    p: Params, cfg: GANConfig, inp: torch.Tensor, *, training: bool = False, folded=None
) -> tuple[torch.Tensor, Params]:
    """inp: (B, z_dim) latents or (B, H, W, 3) images (image-to-image).
    Returns (NHWC image, bn_stats), eval mode only.  The stem is a plain
    matrix product; the deconv trunk is ``_chained_deconv_trunk``.
    ``folded`` is ``fold_eval_bn(p, cfg)``, computed here when not given."""
    if training:
        raise NotImplementedError(_TRAINING_LATER)
    if not uses_chained(cfg.deconv_impl):
        raise ValueError(
            f"deconv_impl {cfg.deconv_impl!r} is not one of {IMPLS}; map it with serve_impl"
        )
    if folded is None:
        folded = fold_eval_bn(p, cfg)
    new_stats: Params = {}
    if cfg.z_dim:
        h = L.linear(p["stem"], inp)
        h = h.reshape(inp.shape[0], cfg.seed_hw, cfg.seed_hw, cfg.stem_ch)
        a, b = folded["stem_bn"]
        h = torch.relu(torch.addcmul(b, h, a))  # eval-mode BN, folded
        new_stats["stem_bn"] = {"mean": p["stem_bn"]["mean"], "var": p["stem_bn"]["var"]}
    else:
        h = inp
        for i, e in enumerate(cfg.encoder):
            h = L.conv2d(p[f"enc{i}"], h, stride=e.stride)
            if e.norm == "batch":
                h, s = L.batchnorm(p[f"enc{i}_bn"], h)
                new_stats[f"enc{i}_bn"] = s
            h = L.ACTIVATIONS[e.act](h)
    img, trunk_stats = _chained_deconv_trunk(p, cfg, h, folded)
    return img, {**new_stats, **trunk_stats}
