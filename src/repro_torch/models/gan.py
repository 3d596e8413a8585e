"""GAN generator on the Winograd DeConv engine, and the discriminator.

The generator's deconv trunk runs either as one cell-to-cell pipeline (the
chained impls) or layer by layer (every other impl), as in the reference.

Chained: every layer is one call of the epilogue-fused engine.  In eval
mode batchnorm is folded into a per-channel scale and bias and the
activation is applied in the engine's finalize; in training mode a
batchnorm layer's engine emits its raw cells and ``_bn_act_cells`` takes
the batch statistics and applies BN and the activation on the cell tensor.
Where the cell layouts line up (``ops.chain_aligned``) a layer emits the
next layer's cells directly; otherwise it emits NHWC pixels and the next
layer re-lays them out.

Per layer (``_deconv_apply``): the deconv, then batchnorm and the
activation in NHWC, in plain PyTorch.

Impl names (``cfg.deconv_impl``), the reference's with ``pallas`` read as
``cuda``; ``cuda*`` take the CUDA kernels for CUDA tensors and their plain
versions for CPU tensors, the ``ref`` names the plain versions everywhere:
  * chained: ``"cuda_chained"``, ``"chained_ref"``;
  * per layer on packed (C, N, M) ``{"ww"}`` weights: ``"cuda_prepacked"``
    (the unfused engine), ``"cuda_fused_pre_prepacked"`` (the fused pre-PE
    engine), ``"prepacked_ref"``;
  * per layer on raw (K, K, N, M) ``{"w"}`` weights, packed per call:
    ``"cuda"``, ``"cuda_fused_pre"``, ``"ref"`` (plain Winograd DeConv);
    and the paper's baselines ``"tdc"``, ``"zero_padded"``, ``"lax"``.
``serve_impl`` maps a training impl onto its serving impl.

The discriminator (``cfg.conv_impl``) runs ``"lax"``, PyTorch's own
convolution as the reference leaves it to XLA, or the Winograd conv
engine: chained (``"cuda_chained"``, ``"chained_ref"``: every K4S2 layer
is one conv-engine call handing the next its phase-major cells,
``ops.conv_cells_to_next``), or per layer (``"cuda_prepacked"``,
``"prepacked_ref"``; raw ``"cuda"``, ``"ref"``), one conv-engine call in
nhwc mode with the bias in its epilogue, then batchnorm and leaky_relu.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import GANConfig
from ..core import lax_deconv2d, tdc_deconv2d, winograd_deconv2d, zero_padded_deconv2d
from ..core.tdc import ConvDims, DeconvDims, conv_same_dims
from ..kernels import ops as kops
from . import layers as L

Params = dict[str, Any]

__all__ = [
    "IMPLS", "PORT_NAMES", "PREPACKED_EQUIV", "CHAINED_EQUIV", "uses_prepacked", "uses_chained", "serve_impl",
    "generator_init", "prepack_generator", "fold_eval_bn", "generator_apply", "DISC_CHANNELS", "CONV_IMPLS",
    "CONV_PREPACKED_EQUIV", "CONV_CHAINED_EQUIV", "uses_prepacked_conv", "uses_chained_conv", "disc_channels",
    "disc_conv_dims", "discriminator_init", "prepack_discriminator", "discriminator_apply", "merge_bn_stats",
]

# chained impl -> winograd_deconv2d_cells kwargs
_CHAINED_KW: dict[str, dict] = {
    "cuda_chained": dict(backend="cuda"),
    "chained_ref": dict(backend="ref"),
}

# per-layer impl on packed (C, N, M) weights -> winograd_deconv2d_packed kwargs
_PREPACKED_KW: dict[str, dict] = {
    "prepacked_ref": dict(backend="ref"),
    "cuda_prepacked": dict(backend="cuda"),
    "cuda_fused_pre_prepacked": dict(backend="cuda", fuse_pre=True),
}

# raw-weight engine impl -> winograd_deconv2d_fused kwargs (packs per call)
_RAW_KW: dict[str, dict] = {
    "cuda": dict(backend="cuda"),
    "cuda_fused_pre": dict(backend="cuda", fuse_pre=True),
}

# the paper's baselines and the plain Winograd DeConv, on raw weights
_RAW_FNS = {"ref": winograd_deconv2d, "tdc": tdc_deconv2d, "zero_padded": zero_padded_deconv2d, "lax": lax_deconv2d}

IMPLS = (*_CHAINED_KW, *_PREPACKED_KW, *_RAW_KW, *_RAW_FNS)

# raw-weight impl -> its prepacked equivalent (same numerics, no per-call pack)
PREPACKED_EQUIV: dict[str, str] = {
    "ref": "prepacked_ref",
    "cuda": "cuda_prepacked",
    "cuda_fused_pre": "cuda_fused_pre_prepacked",
}

# prepacked CUDA impl -> the chained pipeline that serves it
CHAINED_EQUIV: dict[str, str] = {
    "cuda_prepacked": "cuda_chained",
    "cuda_fused_pre_prepacked": "cuda_chained",
}


def uses_prepacked(impl: str) -> bool:
    """True if ``impl`` stores packed Winograd-domain weights in params."""
    return impl in _PREPACKED_KW or impl in _CHAINED_KW


def uses_chained(impl: str) -> bool:
    """True if ``impl`` is one of the port's chained pipelines."""
    return impl in _CHAINED_KW


# reference engine name -> the port's (the *_interpret names have none)
PORT_NAMES: dict[str, str] = {
    "pallas": "cuda",
    "pallas_prepacked": "cuda_prepacked",
    "pallas_fused_pre": "cuda_fused_pre",
    "pallas_fused_pre_prepacked": "cuda_fused_pre_prepacked",
    "pallas_chained": "cuda_chained",
}

# where per-layer serving leaves the reference's tables (see serve_impl)
_PER_LAYER_SERVE: dict[str, str] = {
    "ref": "cuda",
    "chained_ref": "prepacked_ref",
    "cuda_chained": "cuda_fused_pre_prepacked",
}


def serve_impl(impl: str, *, chained: bool = True) -> str:
    """The serving impl for a training ``impl`` (a reference or a port name).

    As the reference: the name in the port's terms (``PORT_NAMES``), then its
    prepacked equivalent (``PREPACKED_EQUIV``), then with ``chained`` its
    chained pipeline (``CHAINED_EQUIV``).  Names already prepacked or
    chained pass through.

    This deviates from the reference on purpose, so that a default config
    serves on the kernels and the plain version only when it is asked for by
    name.  ``chained=True``: every name that is not chained maps to
    ``"cuda_chained"``, ``ref`` and ``prepacked_ref`` included.
    ``chained=False``: ``ref`` serves as ``cuda`` (on ``"cuda_prepacked"``),
    ``chained_ref`` as ``"prepacked_ref"``, ``cuda_chained`` as
    ``"cuda_fused_pre_prepacked"``, and a name with no packed form
    (``tdc``, ``zero_padded``, ``lax``) on ``"cuda_prepacked"``; there the
    reference serves ``ref`` on the plain ``prepacked_ref``."""
    impl = PORT_NAMES.get(impl, impl)
    if chained:
        impl = PREPACKED_EQUIV.get(impl, impl)
        impl = CHAINED_EQUIV.get(impl, impl)
        return impl if impl in _CHAINED_KW else "cuda_chained"
    impl = _PER_LAYER_SERVE.get(impl, impl)
    impl = PREPACKED_EQUIV.get(impl, impl)
    return impl if impl in _PREPACKED_KW else "cuda_prepacked"


def generator_init(
    cfg: GANConfig, *, seed: int = 0, device="cuda", dtype=torch.float32
) -> Params:
    """Random generator params from ``seed``, drawn on ``device``.  Deconv
    weights are raw (K, K, N, M) ``{"w"}`` unless ``cfg.deconv_impl`` keeps
    packed (C, N, M) ``{"ww"}`` (``uses_prepacked``), packed here, once."""
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
        p[f"deconv{i}"] = {"ww": kops.prepack(w, d.dims).ww} if uses_prepacked(cfg.deconv_impl) else {"w": w}
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
        raise ValueError("prepacked impls take packed {'ww'} weights: call prepack_generator first")
    return kops.PackedDeconv(wd["ww"], kops.packed_inv(dims, wd["ww"].device))


def _deconv_apply(impl: str, x: torch.Tensor, wd: Params, dims: DeconvDims) -> torch.Tensor:
    """One deconv layer of the per-layer trunk; ``wd`` is the layer's param
    dict, {"ww": packed} for the prepacked impls, else {"w": raw}."""
    if impl in _PREPACKED_KW:
        return kops.winograd_deconv2d_packed(x, _packed_of(wd, dims), dims, **_PREPACKED_KW[impl])
    if impl not in _RAW_KW and impl not in _RAW_FNS:
        raise ValueError(f"deconv_impl {impl!r} is not one of {IMPLS}")
    if "w" not in wd:
        raise ValueError(f"deconv_impl {impl!r} takes raw {{'w'}} weights, got packed ones")
    if impl in _RAW_KW:
        return kops.winograd_deconv2d_fused(x, wd["w"], dims, **_RAW_KW[impl])
    return _RAW_FNS[impl](x, wd["w"], dims)


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
    deconv trunk is ``_chained_deconv_trunk`` for a chained impl, else one
    ``_deconv_apply`` per layer, each followed by batchnorm and the
    activation.  Eval mode (the default, for serving) folds BN into
    affines: ``folded`` is ``fold_eval_bn(p, cfg)``, computed here when not
    given.  Training mode normalises by batch statistics and returns the
    moved running statistics."""
    if cfg.deconv_impl not in IMPLS:
        raise ValueError(f"deconv_impl {cfg.deconv_impl!r} is not one of {IMPLS}; map it with serve_impl")
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
    if uses_chained(cfg.deconv_impl):
        img, trunk_stats = _chained_deconv_trunk(p, cfg, h, folded, training=training)
        return img, {**new_stats, **trunk_stats}
    for i, d in enumerate(cfg.deconvs):
        h = _deconv_apply(cfg.deconv_impl, h, p[f"deconv{i}"], d.dims)
        if d.norm == "batch":
            bn = p[f"deconv{i}_bn"]
            if training:
                h, new_stats[f"deconv{i}_bn"] = L.batchnorm(bn, h, training=True)
            else:
                a, b = folded[f"deconv{i}_bn"]
                h = torch.addcmul(b, h, a)  # eval-mode BN, folded
                new_stats[f"deconv{i}_bn"] = {"mean": bn["mean"], "var": bn["var"]}
        h = L.ACTIVATIONS[d.act](h)
    return h, new_stats


# ------------------------------------------------------------ discriminator
DISC_CHANNELS: tuple[int, ...] = (64, 128, 256, 512)
DISC_KERNEL, DISC_STRIDE = 4, 2

# per-layer conv impl on packed (C, N, M) convs -> winograd_conv2d_packed kwargs
_CONV_PREPACKED_KW: dict[str, dict] = {
    "prepacked_ref": dict(backend="ref"),
    "cuda_prepacked": dict(backend="cuda"),
}
# raw-weight conv impl -> winograd_conv2d kwargs (packs per call)
_CONV_RAW_KW: dict[str, dict] = {
    "ref": dict(backend="ref"),
    "cuda": dict(backend="cuda"),
}
CONV_IMPLS = ("lax", *_CHAINED_KW, *_CONV_PREPACKED_KW, *_CONV_RAW_KW)
CONV_PREPACKED_EQUIV: dict[str, str] = {"ref": "prepacked_ref", "cuda": "cuda_prepacked"}
CONV_CHAINED_EQUIV: dict[str, str] = {"cuda_prepacked": "cuda_chained"}


def uses_prepacked_conv(impl: str) -> bool:
    """True if ``impl`` stores packed ``{"ww", "b"}`` convs in the
    discriminator params."""
    return impl in _CONV_PREPACKED_KW or impl in _CHAINED_KW


def uses_chained_conv(impl: str) -> bool:
    """True if ``impl`` runs the discriminator trunk as one chained
    conv-engine pipeline."""
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
        raise ValueError("prepacked conv impls take packed {'ww', 'b'} convs: call prepack_discriminator first")
    return kops.PackedConv(wd["ww"], kops.conv_packed_inv(cdims, wd["ww"].device))


def _disc_conv_apply(impl: str, x: torch.Tensor, wd: Params, cdims: ConvDims) -> torch.Tensor:
    """One per-layer discriminator conv; the winograd impls run the conv
    engine in nhwc mode with the bias in its epilogue."""
    if impl == "lax":
        return L.conv2d(wd, x, stride=DISC_STRIDE)
    if impl in _CONV_RAW_KW:
        if "w" not in wd:
            raise ValueError(f"conv_impl {impl!r} takes raw {{'w', 'b'}} convs, got packed ones")
        return kops.winograd_conv2d(x, wd["w"], cdims, bias=wd["b"].float(), **_CONV_RAW_KW[impl])
    return kops.winograd_conv2d_packed(x, _packed_conv_of(wd, cdims), cdims, bias=wd["b"].float(),
                                       **_CONV_PREPACKED_KW[impl])


def discriminator_init(cfg: GANConfig, *, seed: int = 0, device="cuda", dtype=torch.float32) -> Params:
    """Random discriminator params from ``seed``, drawn on ``device``: K4S2
    convs ``conv{i}`` {w (4, 4, C_in, C_out), b} (packed {ww (C, N, M), b}
    where ``uses_prepacked_conv(cfg.conv_impl)``), batchnorm after every
    conv but the first, and a linear ``head`` to one logit."""
    _check_conv_impl(cfg.conv_impl)
    gen = torch.Generator(device=device).manual_seed(seed)
    chans = [cfg.img_ch, *disc_channels(cfg)]
    dims = disc_conv_dims(cfg)
    p: Params = {}
    for i in range(len(chans) - 1):
        wd = L.conv2d_init(gen, DISC_KERNEL, chans[i], chans[i + 1], dtype)
        if uses_prepacked_conv(cfg.conv_impl):  # G-transform and pack once, here
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
    """img (B, H, W, C) NHWC -> (logits (B, 1), bn_stats).  A chained
    ``conv_impl`` runs ``_chained_conv_trunk``; every other impl runs per
    layer: the conv (``_disc_conv_apply``: "lax" or the Winograd conv
    engine), batchnorm (batch statistics in training mode), leaky_relu,
    then the linear head.  All compute the same function."""
    _check_conv_impl(cfg.conv_impl)
    if uses_chained_conv(cfg.conv_impl):
        return _chained_conv_trunk(p, cfg, img, training=training)
    dims = disc_conv_dims(cfg)
    h, new_stats = img, {}
    i = 0
    while f"conv{i}" in p:
        h = _disc_conv_apply(cfg.conv_impl, h, p[f"conv{i}"], dims[i])
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
