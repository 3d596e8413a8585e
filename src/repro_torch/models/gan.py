"""GAN generator on the Winograd DeConv engine, and the discriminator.

The generator's deconv trunk runs as one cell-to-cell pipeline: every layer
is one call of the epilogue-fused engine.  In eval mode batchnorm is folded
into a per-channel scale and bias and the activation is applied in the
engine's finalize; in training mode a batchnorm layer's engine emits its
raw cells and ``_bn_act_cells`` takes the batch statistics and applies BN
and the activation on the cell tensor.  Where the cell layouts line up
(``ops.chain_aligned``) a layer emits the next layer's cells directly;
otherwise it emits NHWC pixels and the next layer re-lays them out.

Impl names (``cfg.deconv_impl``):
  * ``"cuda_chained"``: the CUDA engine for CUDA tensors, its plain version
    for CPU tensors;
  * ``"chained_ref"``: the plain version on every device.
``serve_impl`` maps the reference's impl names (``ref``, ``prepacked_ref``,
``pallas*``, ...) onto ``"cuda_chained"``; they all compute this function.

The discriminator (``cfg.conv_impl``) runs ``"lax"``, PyTorch's own
convolution as the reference leaves it to XLA, or the same two chained impl
names on the Winograd conv engine: every K4S2 layer is one conv-engine call
and hands the next its phase-major cells (``ops.conv_cells_to_next``).
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import GANConfig
from ..core.tdc import ConvDims, DeconvDims, conv_same_dims
from ..kernels import ops as kops
from . import layers as L

Params = dict[str, Any]

__all__ = [
    "IMPLS", "uses_chained", "serve_impl", "generator_init", "prepack_generator",
    "fold_eval_bn", "generator_apply", "DISC_CHANNELS", "CONV_IMPLS", "uses_chained_conv", "disc_channels",
    "disc_conv_dims", "discriminator_init", "prepack_discriminator", "discriminator_apply", "merge_bn_stats",
]

# chained impl -> winograd_deconv2d_cells kwargs
_CHAINED_KW: dict[str, dict] = {
    "cuda_chained": dict(backend="cuda"),
    "chained_ref": dict(backend="ref"),
}
IMPLS = tuple(_CHAINED_KW)


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


def _cells_to_image(c: torch.Tensor, out_hw: tuple[int, int], padding: int = 0) -> torch.Tensor:
    """Emitted cell layout (B, R, Cc, m*m, M) -> the cropped NHWC image."""
    B, R, Cc, m2, M = c.shape
    m = int(round(m2**0.5))
    img = c.reshape(B, R, Cc, m, m, M).permute(0, 1, 3, 2, 4, 5).reshape(B, R * m, Cc * m, M)
    return img[:, padding : padding + out_hw[0], padding : padding + out_hw[1]]


def _bn_act_cells(
    bn: Params,
    emitted: torch.Tensor,  # raw emit_cells output (B, R, Cc, m*m, M)
    out_hw: tuple[int, int],
    *,
    act: str,
    padding: int = 0,
    momentum: float = 0.9,
    eps: float = 1e-5,
):
    """Training-mode batchnorm + activation on the emitted cell tensor.  The
    cells are a relayout of the layer's output pixels with everything
    outside the crop window zero, so the batch statistics are plain sums
    over the tensor divided by the window's pixel count; the crop mask
    re-zeroes the outside after the affine and the activation, so the next
    engine call takes the result directly.  Returns (cells, new_stats)."""
    M = bn["scale"].shape[0]
    c = emitted[..., :M].float()
    B, R, Cc, m2, _ = c.shape
    m = int(round(m2**0.5))
    count = B * out_hw[0] * out_hw[1]
    mean = c.sum(dim=(0, 1, 2, 3)) / count
    ex2 = (c * c).sum(dim=(0, 1, 2, 3)) / count
    # one-pass E[x^2] - mean^2 can dip below 0 under fp32 cancellation
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    y = (c - mean) * torch.rsqrt(var + eps)
    y = y * bn["scale"].float() + bn["bias"].float()
    y = L.ACTIVATIONS[act](y)
    mask = kops.cells_window_mask(R, Cc, m, padding, out_hw[0], out_hw[1], device=c.device)
    new = {
        "mean": momentum * bn["mean"] + (1 - momentum) * mean,
        "var": momentum * bn["var"] + (1 - momentum) * var,
    }
    return (y * mask).to(emitted.dtype), new


def _chained_deconv_trunk(
    p: Params, cfg: GANConfig, h: torch.Tensor, folded, *, training: bool = False
) -> tuple[torch.Tensor, Params]:
    """The deconv trunk as one engine-domain pipeline: one fused-engine call
    per layer.  Eval mode (and BN-free layers in either mode) applies the
    folded BN and the activation in the engine's finalize; training-mode BN
    layers emit raw cells and run ``_bn_act_cells`` (misaligned hops: NHWC
    out, ``layers.batchnorm``, then a cells re-layout).  Returns (image,
    bn_stats)."""
    kw = _CHAINED_KW[cfg.deconv_impl]
    new_stats: Params = {}
    hw = (h.shape[1], h.shape[2])
    cells = kops.cells_from_image(h, cfg.deconvs[0].dims)
    img = None
    for i, d in enumerate(cfg.deconvs):
        packed = _packed_of(p[f"deconv{i}"], d.dims)
        has_bn = d.norm == "batch"
        nxt = cfg.deconvs[i + 1].dims if i + 1 < len(cfg.deconvs) else None
        out_hw = (d.dims.out_size(hw[0]), d.dims.out_size(hw[1]))
        aligned = nxt is not None and kops.chain_aligned(d.dims, nxt)
        if training and has_bn:
            bn = p[f"deconv{i}_bn"]
            if aligned:
                emitted = kops.winograd_deconv2d_cells(cells, packed, d.dims, hw, emit_cells=True, **kw)
                y_cells, stats = _bn_act_cells(bn, emitted, out_hw, act=d.act, padding=d.dims.padding)
                cells = kops.cells_to_next(y_cells, d.dims, nxt, out_hw)
            else:  # misaligned hop (or BN on the last layer): NHWC fallback
                img = kops.winograd_deconv2d_cells(cells, packed, d.dims, hw, **kw)
                img, stats = L.batchnorm(bn, img, training=True)
                img = L.ACTIVATIONS[d.act](img)
                if nxt is not None:
                    cells = kops.cells_from_image(img, nxt)
            new_stats[f"deconv{i}_bn"] = stats
        else:
            scale = bias = None
            if has_bn:
                bn = p[f"deconv{i}_bn"]
                scale, bias = folded[f"deconv{i}_bn"]
                new_stats[f"deconv{i}_bn"] = {"mean": bn["mean"], "var": bn["var"]}
            if aligned:
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
    Returns (NHWC image, bn_stats).  The stem is a plain matrix product; the
    deconv trunk is ``_chained_deconv_trunk``.  Eval mode (the default,
    for serving) folds BN into affines: ``folded`` is ``fold_eval_bn(p,
    cfg)``, computed here when not given.  Training mode normalises by batch
    statistics and returns the moved running statistics."""
    if not uses_chained(cfg.deconv_impl):
        raise ValueError(
            f"deconv_impl {cfg.deconv_impl!r} is not one of {IMPLS}; map it with serve_impl"
        )
    if folded is None and not training:
        folded = fold_eval_bn(p, cfg)
    new_stats: Params = {}
    if cfg.z_dim:
        h = L.linear(p["stem"], inp)
        h = h.reshape(inp.shape[0], cfg.seed_hw, cfg.seed_hw, cfg.stem_ch)
        if training:
            h, new_stats["stem_bn"] = L.batchnorm(p["stem_bn"], h, training=True)
            h = torch.relu(h)
        else:
            a, b = folded["stem_bn"]
            h = torch.relu(torch.addcmul(b, h, a))  # eval-mode BN, folded
            new_stats["stem_bn"] = {"mean": p["stem_bn"]["mean"], "var": p["stem_bn"]["var"]}
    else:
        h = inp
        for i, e in enumerate(cfg.encoder):
            h = L.conv2d(p[f"enc{i}"], h, stride=e.stride)
            if e.norm == "batch":
                h, s = L.batchnorm(p[f"enc{i}_bn"], h, training=training)
                new_stats[f"enc{i}_bn"] = s
            h = L.ACTIVATIONS[e.act](h)
    img, trunk_stats = _chained_deconv_trunk(p, cfg, h, folded, training=training)
    return img, {**new_stats, **trunk_stats}


# ------------------------------------------------------------ discriminator
DISC_CHANNELS: tuple[int, ...] = (64, 128, 256, 512)
DISC_KERNEL, DISC_STRIDE = 4, 2
# "lax" or one of the chained impls, which take the same backends as the generator's
CONV_IMPLS = ("lax", *IMPLS)


def uses_chained_conv(impl: str) -> bool:
    """True if ``impl`` runs the discriminator trunk as one chained
    conv-engine pipeline (its params hold packed ``{"ww", "b"}`` convs)."""
    return impl in _CHAINED_KW


def _check_conv_impl(impl: str) -> None:
    if impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {impl!r} is not one of {CONV_IMPLS}")


def disc_channels(cfg: GANConfig) -> tuple[int, ...]:
    """Trunk widths of the discriminator for this config."""
    return tuple(getattr(cfg, "disc_channels", DISC_CHANNELS))


def disc_conv_dims(cfg: GANConfig) -> tuple[ConvDims, ...]:
    """Per-layer ConvDims of the trunk: K4S2 with "SAME" pads for each
    layer's input extent, the geometry of ``layers.conv2d(stride=2)``."""
    h, out = cfg.img_hw, []
    for _ in disc_channels(cfg):
        cd = conv_same_dims(DISC_KERNEL, DISC_STRIDE, h)
        out.append(cd)
        h = cd.out_size(h)
    return tuple(out)


def _packed_conv_of(wd: Params, cdims: ConvDims) -> kops.PackedConv:
    if "ww" not in wd:
        raise ValueError("chained conv impls take packed {'ww', 'b'} convs: call prepack_discriminator first")
    return kops.PackedConv(wd["ww"], kops.conv_packed_inv(cdims, wd["ww"].device))


def discriminator_init(cfg: GANConfig, *, seed: int = 0, device="cuda", dtype=torch.float32) -> Params:
    """Random discriminator params from ``seed``, drawn on ``device``: K4S2
    convs ``conv{i}`` {w (4, 4, C_in, C_out), b} (packed {ww (C, N, M), b}
    for a chained ``cfg.conv_impl``), batchnorm after every conv but the
    first, and a linear ``head`` to one logit."""
    _check_conv_impl(cfg.conv_impl)
    gen = torch.Generator(device=device).manual_seed(seed)
    chans = [cfg.img_ch, *disc_channels(cfg)]
    dims = disc_conv_dims(cfg)
    p: Params = {}
    for i in range(len(chans) - 1):
        wd = L.conv2d_init(gen, DISC_KERNEL, chans[i], chans[i + 1], dtype)
        if uses_chained_conv(cfg.conv_impl):  # G-transform and pack once, here
            wd = {"ww": kops.prepack_conv(wd["w"], dims[i]).ww, "b": wd["b"]}
        p[f"conv{i}"] = wd
        if i > 0:
            p[f"conv{i}_bn"] = L.batchnorm_init(chans[i + 1], device, dtype)
    final_hw = cfg.img_hw // 2 ** (len(chans) - 1)
    p["head"] = L.linear_init(gen, final_hw**2 * chans[-1], 1, dtype)
    return p


def prepack_discriminator(params: Params, cfg: GANConfig) -> Params:
    """Raw conv weights -> packed (C, N, M) ``{"ww", "b"}``, once.  Packed
    leaves pass through untouched."""
    out = dict(params)
    for i, cd in enumerate(disc_conv_dims(cfg)):
        wd = params.get(f"conv{i}")
        if wd is not None and "w" in wd:
            out[f"conv{i}"] = {"ww": kops.prepack_conv(wd["w"], cd).ww, "b": wd["b"]}
    return out


def _chained_conv_trunk(
    p: Params, cfg: GANConfig, img: torch.Tensor, *, training: bool = True
) -> tuple[torch.Tensor, Params]:
    """The discriminator trunk as one conv-engine pipeline: one engine call
    per K4S2 layer, each handing the next its phase-major cells (with
    m = S = 2 every output cell is one phase pair of the next layer).  The
    conv bias is always in the engine's epilogue; eval mode also folds
    running-stat BN and leaky_relu into it; training-mode BN layers emit raw
    cells and run ``_bn_act_cells``.  The last layer turns into pixels only
    for the linear head.  Returns (logits, bn_stats)."""
    kw = _CHAINED_KW[cfg.conv_impl]
    dims = disc_conv_dims(cfg)
    new_stats: Params = {}
    hw = (img.shape[1], img.shape[2])
    cells = kops.conv_cells_from_image(img, dims[0])
    for i, cd in enumerate(dims):
        wd = p[f"conv{i}"]
        packed = _packed_conv_of(wd, cd)
        b = wd["b"].float()
        has_bn = f"conv{i}_bn" in p
        last = i + 1 == len(dims)
        out_hw = (cd.out_size(hw[0]), cd.out_size(hw[1]))
        if training and has_bn:
            emitted = kops.winograd_conv2d_cells(cells, packed, cd, hw, bias=b, emit_cells=True, **kw)
            out, new_stats[f"conv{i}_bn"] = _bn_act_cells(p[f"conv{i}_bn"], emitted, out_hw, act="leaky_relu")
            if last:
                out = _cells_to_image(out, out_hw)
        else:
            scale, bias = None, b
            if has_bn:
                bn = p[f"conv{i}_bn"]
                a, bb = _bn_eval_affine(bn)
                scale, bias = a, (a * b + bb).contiguous()
                new_stats[f"conv{i}_bn"] = {"mean": bn["mean"], "var": bn["var"]}
            out = kops.winograd_conv2d_cells(cells, packed, cd, hw, epilogue="leaky_relu", scale=scale, bias=bias,
                                             emit_cells=not last, **kw)
        if not last:
            cells = kops.conv_cells_to_next(out, cd, dims[i + 1], out_hw)
        hw = out_hw
    return L.linear(p["head"], out.reshape(out.shape[0], -1)), new_stats


def discriminator_apply(
    p: Params, cfg: GANConfig, img: torch.Tensor, *, training: bool = True
) -> tuple[torch.Tensor, Params]:
    """img (B, H, W, C) NHWC -> (logits (B, 1), bn_stats).  ``conv_impl``
    "lax": conv, batchnorm (batch statistics in training mode), leaky_relu
    per layer, then the linear head; a chained impl: ``_chained_conv_trunk``,
    the same function on the Winograd conv engine."""
    _check_conv_impl(cfg.conv_impl)
    if uses_chained_conv(cfg.conv_impl):
        return _chained_conv_trunk(p, cfg, img, training=training)
    h, new_stats = img, {}
    i = 0
    while f"conv{i}" in p:
        h = L.conv2d(p[f"conv{i}"], h, stride=DISC_STRIDE)
        if f"conv{i}_bn" in p:
            h, new_stats[f"conv{i}_bn"] = L.batchnorm(p[f"conv{i}_bn"], h, training=training)
        h = L.leaky_relu(h)
        i += 1
    return L.linear(p["head"], h.reshape(h.shape[0], -1)), new_stats


def merge_bn_stats(params: Params, stats: Params) -> Params:
    """Fold updated running BN stats back into the param tree."""
    out = dict(params)
    for k, s in stats.items():
        out[k] = {**params[k], **s}
    return out
