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

The per-layer applies read the block table (``DECONV_BLOCKS``): each
layer's kernel configurations, keyed by (impl, dims, N, M), which
``install_tuned_blocks`` fills from ``kernels.autotune`` and
``set_deconv_blocks`` by hand.

Serving keeps a registry of serve-ready packed generators
(``register_prepacked_generator`` / ``get_prepacked_generator``) that
``serve.GanServeEngine(models=...)`` takes, the health hooks its circuit
breaker asks (``params_finite``, ``generator_health``), and the export
path back to raw weights (``unpack_generator``).

Impl names (``cfg.deconv_impl``), the reference's with ``pallas`` read as
``cuda``; ``cuda*`` take the CUDA kernels for CUDA tensors and their plain
versions for CPU tensors, the ``ref`` names the plain versions everywhere:
  * chained: ``"cuda_chained"``, ``"chained_ref"``;
  * per layer on packed (C, N, M) ``{"ww"}`` weights: ``"cuda_prepacked"``
    (the unfused engine), ``"cuda_fused_pre_prepacked"`` (the fused pre-PE
    engine), ``"prepacked_ref"``;
  * per layer on raw (K, K, N, M) ``{"w"}`` weights, packed per call:
    ``"cuda"``, ``"cuda_fused_pre"``, ``"ref"`` (plain Winograd DeConv),
    ``"ref_bf16"`` (its channel contraction on bf16 operands, fp32
    accumulation), ``"ref_dense"`` (the same without the structural-zero
    skip: the conventional Winograd ablation); and the paper's baselines
    ``"tdc"``, ``"zero_padded"``, ``"lax"``.
``serve_impl`` maps a training impl onto its serving impl.

The discriminator (``cfg.conv_impl``) runs ``"lax"``, PyTorch's own
convolution as the reference leaves it to XLA, or the Winograd conv
engine: chained (``"cuda_chained"``, ``"chained_ref"``: every K4S2 layer
is one conv-engine call handing the next its phase-major cells,
``ops.conv_cells_to_next``), or per layer (``"cuda_prepacked"``,
``"prepacked_ref"``; raw ``"cuda"``, ``"ref"``), one conv-engine call in
nhwc mode with the bias in its epilogue, then batchnorm and leaky_relu.

The audio decoder (``audio_decoder_init`` / ``audio_decoder_apply``) is a
stack of 1D K4S2 deconvs on the 1D engine, each followed by its bias and
activation (``AUDIO_IMPLS``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from ..configs.base import Deconv1dSpec, GANConfig
from ..core import lax_deconv2d, tdc_deconv2d, winograd_deconv2d, zero_padded_deconv2d
from ..core.tdc import ConvDims, DeconvDims, conv_same_dims, tdc_deconv1d
from ..kernels import ops as kops
from ..tree import tree_leaves, tree_map
from . import layers as L

Params = dict[str, Any]

__all__ = [
    "IMPLS", "PORT_NAMES", "PREPACKED_EQUIV", "CHAINED_EQUIV", "uses_prepacked", "uses_chained", "serve_impl",
    "DECONV_BLOCKS", "set_deconv_blocks", "clear_deconv_blocks", "install_tuned_blocks",
    "generator_init", "prepack_generator", "packed_generator_specs", "place_params", "gather_params",
    "fold_eval_bn", "generator_apply", "PrepackedGenerator",
    "register_prepacked_generator", "get_prepacked_generator", "registered_archs", "clear_prepacked_generators",
    "params_finite", "generator_health", "unpack_generator", "DISC_CHANNELS", "CONV_IMPLS",
    "CONV_PREPACKED_EQUIV", "CONV_CHAINED_EQUIV", "uses_prepacked_conv", "uses_chained_conv", "disc_channels",
    "disc_conv_dims", "discriminator_init", "prepack_discriminator", "discriminator_apply", "merge_bn_stats",
    "AUDIO_IMPLS", "lax_deconv1d", "audio_decoder_init", "audio_decoder_apply",
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

# the paper's baselines and the plain Winograd DeConv (fp32, bf16 operands,
# and bf16 without the structural-zero skip), on raw weights
_RAW_FNS = {
    "ref": winograd_deconv2d,
    "ref_bf16": functools.partial(winograd_deconv2d, bf16=True),
    "ref_dense": functools.partial(winograd_deconv2d, dense=True, bf16=True),
    "tdc": tdc_deconv2d,
    "zero_padded": zero_padded_deconv2d,
    "lax": lax_deconv2d,
}

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
    (``tdc``, ``zero_padded``, ``lax``, ``ref_bf16``, ``ref_dense``) on
    ``"cuda_prepacked"``; there the reference serves ``ref`` on the plain
    ``prepacked_ref`` and the others on their own raw-weight paths.  So the
    bf16 names serve on the fp32 kernels, as ``tdc`` and ``lax`` do.

    A registry entry (``register_prepacked_generator``) holds the impl this
    function gave at registration.  An engine serves it where the
    reference's would (there this function passes chained and plain packed
    names through): an entry registered chained stays chained on a
    ``chained=False`` engine, ``prepacked_ref`` stays plain, and a
    per-layer kernel entry follows the engine's ``chained``."""
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


def prepack_generator(params: Params, cfg: GANConfig, mesh=None) -> Params:
    """Raw deconv weights -> packed (C, N, M) ``{"ww"}``, once.  Packed
    leaves pass through untouched.  With ``mesh`` the packed tree is placed
    per ``parallel.sharding.gan_param_specs``: this rank's block of every
    leaf (``block_of``; batchnorm leaves are replicated), as the reference
    places it on the mesh; ``gather`` over the same specs gives it back."""
    out = dict(params)
    for i, d in enumerate(cfg.deconvs):
        wd = params[f"deconv{i}"]
        if "w" in wd:
            out[f"deconv{i}"] = {"ww": kops.prepack(wd["w"], d.dims).ww}
    if mesh is not None:
        out = place_params(out, packed_generator_specs(cfg, mesh), mesh)
    return out


def packed_generator_specs(cfg: GANConfig, mesh):
    """The spec tree of ``prepack_generator``'s output on ``mesh``
    (``gan_param_specs``' generator half; the specs depend only on packed
    versus raw leaves, so any prepacked impl names this tree)."""
    from ..parallel import sharding as SH

    if not uses_prepacked(cfg.deconv_impl):
        cfg = dataclasses.replace(cfg, deconv_impl=PREPACKED_EQUIV.get(cfg.deconv_impl, "prepacked_ref"))
    return SH.gan_param_specs(cfg, mesh)[0]


def place_params(params: Params, specs, mesh) -> Params:
    """This rank's blocks of a full tree under ``specs`` (no collective)."""
    from ..parallel import sharding as SH

    return SH.map_specs(lambda leaf, sp: SH.block_of(leaf, sp, mesh), params, specs)


def gather_params(blocks: Params, specs, mesh) -> Params:
    """The full tree from every rank's blocks (an ``all_gather`` a split
    leaf, in the tree's order: every rank of the mesh calls it)."""
    from ..parallel import sharding as SH

    return SH.map_specs(lambda leaf, sp: SH.gather(leaf, sp, mesh), blocks, specs)


# ---------------------------------------------------------- block overrides
# Per-layer kernel configurations, keyed by (impl, dims, N, M): the
# autotuner's winning forward AND backward choices (the Hopper counterparts
# of the reference's block_* / bwd_block_*: the instantiation and split of
# each launch, ``kernels.engine.INSTANTIATIONS``) land here and are merged
# into that impl's applies.  Keying by impl keeps a winner of one engine
# variant away from another, and the ``ref`` impls never read it.  The key
# holds no batch, as the reference's: a table tuned at the training batch
# also configures a serving generate of the same layers.  Populated by
# ``install_tuned_blocks`` (or by hand via ``set_deconv_blocks``).
DECONV_BLOCKS: dict[tuple, dict] = {}

_BLOCK_KEYS = ("conf", "splits", "bwd_x_conf", "bwd_w_conf", "bwd_w_splits")


def set_deconv_blocks(impl: str, dims, n_in: int, m_out: int, **blocks) -> None:
    """Register kernel configurations for ``impl`` on every layer with this
    (geometry, N, M) signature (a deconv's ``DeconvDims`` or a
    discriminator conv's ``ConvDims``); None values are dropped (the plan's
    choice)."""
    bad = set(blocks) - set(_BLOCK_KEYS)
    if bad:
        raise ValueError(f"unknown block keys {sorted(bad)}")
    DECONV_BLOCKS[(impl, dims, n_in, m_out)] = {k: v for k, v in blocks.items() if v is not None}


def clear_deconv_blocks() -> None:
    DECONV_BLOCKS.clear()


def install_tuned_blocks(cfg: GANConfig, *, mode: str = "grad", batch: int = 1, candidates=None,
                         **autotune_kw) -> list[dict]:
    """Run ``kernels.autotune.autotune_deconv`` per generator layer and wire
    each layer's winning config, its backward choices included, into the
    impl table.  Returns the per-layer winner rows for logging.

    The default candidate grid is restricted to the engine variant
    ``cfg.deconv_impl`` actually runs (fused-pre vs unfused, prepacked), and
    winners from a different variant are skipped: numbers measured on a
    code path the model never executes must not land in the table."""
    from ..kernels.autotune import autotune_deconv, candidate_configs

    impl = cfg.deconv_impl
    fused = _PREPACKED_KW.get(impl, {}).get("fuse_pre", False)
    if candidates is None:
        candidates = candidate_configs(include_fused=fused, include_unfused=not fused, prepack=uses_prepacked(impl))
    installed = []
    h = cfg.seed_hw
    for li, d in enumerate(cfg.deconvs):
        rows = autotune_deconv(d.dims, (batch, h, h, d.c_in), d.c_out, mode=mode, candidates=candidates,
                               **autotune_kw)
        won = next((r for r in rows if r["ok"] and r["config"].fuse_pre == fused), None)
        if won is not None:
            c = won["config"]
            set_deconv_blocks(impl, d.dims, d.c_in, d.c_out, **{k: getattr(c, k) for k in _BLOCK_KEYS})
            installed.append({"layer": li, "ms": won["ms"], "config": c})
        else:
            installed.append({"layer": li, "error": rows[0]["error"]})
        h = d.dims.out_size(h)
    return installed


def _packed_of(wd: Params, dims: DeconvDims) -> kops.PackedDeconv:
    if "ww" not in wd:
        raise ValueError("prepacked impls take packed {'ww'} weights: call prepack_generator first")
    return kops.PackedDeconv(wd["ww"], kops.packed_inv(dims, wd["ww"].device))


def _deconv_apply(impl: str, x: torch.Tensor, wd: Params, dims: DeconvDims) -> torch.Tensor:
    """One deconv layer of the per-layer trunk; ``wd`` is the layer's param
    dict, {"ww": packed} for the prepacked impls, else {"w": raw}.  The
    prepacked kernel impls take their layer's entry of ``DECONV_BLOCKS``."""
    if impl in _PREPACKED_KW:
        kw = dict(_PREPACKED_KW[impl])
        if kw.get("backend") == "cuda":
            ww = wd["ww"]
            kw.update(DECONV_BLOCKS.get((impl, dims, ww.shape[1], ww.shape[2]), {}))
        return kops.winograd_deconv2d_packed(x, _packed_of(wd, dims), dims, **kw)
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
    # sync-BN: inside ``L.bn_sync_axis`` the moments are averaged over the
    # data shards, the single-device step's statistics (equal shards)
    mean, ex2 = L.bn_sync_moments(mean, ex2)
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
    bn_stats).  Like the reference's it takes ``_CHAINED_KW`` alone and reads
    no ``DECONV_BLOCKS`` entry: an entry installed for ``cuda_chained``
    reaches only the layers that run the per-layer apply."""
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


# ------------------------------------------------ registry of packed generators
@dataclasses.dataclass(frozen=True)
class PrepackedGenerator:
    """A serve-ready resident generator: arch id, config with the serving
    impl substituted (``serve_impl``), and packed (C, N, M) weights on
    their device; the G-transform is paid when the entry is built, never on
    a request path.  ``serve.GanServeEngine(models=...)`` takes these, or
    arch-id strings resolved through ``get_prepacked_generator``.  An entry
    registered with a ``mesh`` holds this rank's blocks of the weights
    (``mesh`` is that mesh; None: the full tree)."""

    arch_id: str
    cfg: GANConfig
    params: Params
    mesh: Any = None


_SERVE_REGISTRY: dict[str, PrepackedGenerator] = {}


def register_prepacked_generator(arch_id: str, params: Params, cfg: GANConfig, *, device="cuda", mesh=None,
                                 chained: bool = True) -> PrepackedGenerator:
    """Pack ``params`` for serving on ``device`` and register them under
    ``arch_id``, so launch scripts, benchmarks and engines share one
    resident copy per arch.  Re-registering an arch replaces its entry.
    With ``mesh`` (every rank registers, with the same full ``params``) the
    entry holds this rank's blocks, placed per ``gan_param_specs`` on the
    mesh's device; an engine on the same mesh gathers them per generate."""
    cfg_s = dataclasses.replace(cfg, deconv_impl=serve_impl(cfg.deconv_impl, chained=chained))
    if mesh is not None:
        device = mesh.device
    moved = tree_map(lambda v: v.to(device, torch.float32).contiguous(), params)
    entry = PrepackedGenerator(arch_id=arch_id, cfg=cfg_s, params=prepack_generator(moved, cfg_s, mesh=mesh),
                               mesh=mesh)
    _SERVE_REGISTRY[arch_id] = entry
    return entry


def get_prepacked_generator(arch_id: str) -> PrepackedGenerator:
    """The registered serve-ready generator for ``arch_id``."""
    try:
        return _SERVE_REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"no prepacked generator registered for {arch_id!r} "
                       f"(registered: {sorted(_SERVE_REGISTRY)})") from None


def registered_archs() -> tuple[str, ...]:
    return tuple(sorted(_SERVE_REGISTRY))


def clear_prepacked_generators() -> None:
    _SERVE_REGISTRY.clear()


# ------------------------------------------------------ resident health hooks
def params_finite(params: Params) -> bool:
    """True iff every floating-point leaf of ``params`` is fully finite.

    The serve engine's half-open probe asks this before it re-admits a
    quarantined resident: weights poisoned by NaN or Inf cannot produce a
    good batch.  One fused max-|x| reduction over all the leaves of a
    device (``torch._foreach_norm``, which keeps NaN), then one host read
    per device: no read per leaf on the dispatch path."""
    by_device: dict[torch.device, list[torch.Tensor]] = {}
    for leaf in tree_leaves(params):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            by_device.setdefault(leaf.device, []).append(leaf)
    return all(bool(torch.isfinite(torch.stack(torch._foreach_norm(leaves, float("inf")))).all())
               for leaves in by_device.values())


def generator_health(params: Params, cfg: Optional[GANConfig] = None) -> dict:
    """Diagnostic health row for a (possibly packed) generator: leaf count,
    parameter count, and whether every weight is finite."""
    leaves = [leaf for leaf in tree_leaves(params) if isinstance(leaf, torch.Tensor)]
    return {
        "finite": params_finite(params),
        "n_leaves": len(leaves),
        "n_params": int(sum(leaf.numel() for leaf in leaves)),
        "prepacked": cfg is not None and uses_prepacked(cfg.deconv_impl),
    }


def unpack_generator(params: Params, cfg: GANConfig) -> Params:
    """Checkpoint export, the inverse of ``prepack_generator``: packed
    Winograd-domain deconv weights -> raw (K_D, K_D, N, M) ones by least
    squares through the G-transform and the pack
    (``kernels.ops.unpack_weights``).  Raw ``{"w"}`` leaves pass through,
    so prepack -> unpack round-trips."""
    out = dict(params)
    for i, d in enumerate(cfg.deconvs):
        wd = params[f"deconv{i}"]
        if "ww" in wd:
            out[f"deconv{i}"] = {"w": kops.unpack_weights(wd["ww"], d.dims)}
    return out


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
    engine in nhwc mode with the bias in its epilogue, the prepacked kernel
    impl on its layer's entry of ``DECONV_BLOCKS``."""
    if impl == "lax":
        return L.conv2d(wd, x, stride=DISC_STRIDE)
    if impl in _CONV_RAW_KW:
        if "w" not in wd:
            raise ValueError(f"conv_impl {impl!r} takes raw {{'w', 'b'}} convs, got packed ones")
        return kops.winograd_conv2d(x, wd["w"], cdims, bias=wd["b"].float(), **_CONV_RAW_KW[impl])
    kw = dict(_CONV_PREPACKED_KW[impl])
    if kw.get("backend") == "cuda":
        ww = wd["ww"]
        kw.update(DECONV_BLOCKS.get((impl, cdims, ww.shape[1], ww.shape[2]), {}))
    return kops.winograd_conv2d_packed(x, _packed_conv_of(wd, cdims), cdims, bias=wd["b"].float(), **kw)


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


def prepack_discriminator(params: Params, cfg: GANConfig, mesh=None) -> Params:
    """Raw conv weights -> packed (C, N, M) ``{"ww", "b"}``, once.  Packed
    leaves pass through untouched.  With ``mesh`` the packed tree is placed
    per ``gan_param_specs``' discriminator half: this rank's blocks."""
    out = dict(params)
    for i, cd in enumerate(disc_conv_dims(cfg)):
        wd = params.get(f"conv{i}")
        if wd is not None and "w" in wd:
            out[f"conv{i}"] = {"ww": kops.prepack_conv(wd["w"], cd).ww, "b": wd["b"]}
    if mesh is not None:
        from ..parallel import sharding as SH

        cfg_p = cfg if uses_prepacked_conv(cfg.conv_impl) else dataclasses.replace(
            cfg, conv_impl=CONV_PREPACKED_EQUIV.get(cfg.conv_impl, "prepacked_ref"))
        out = place_params(out, SH.gan_param_specs(cfg_p, mesh)[1], mesh)
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
    for the linear head; each layer takes its entry of ``DECONV_BLOCKS``
    on the kernels.  Returns (logits, bn_stats)."""
    base_kw = _CHAINED_KW[cfg.conv_impl]
    dims = disc_conv_dims(cfg)
    new_stats: Params = {}
    hw = (img.shape[1], img.shape[2])
    cells = kops.conv_cells_from_image(img, dims[0])
    for i, cd in enumerate(dims):
        wd = p[f"conv{i}"]
        kw = dict(base_kw)
        if kw.get("backend") == "cuda" and "ww" in wd:
            kw.update(DECONV_BLOCKS.get((cfg.conv_impl, cd, wd["ww"].shape[1], wd["ww"].shape[2]), {}))
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


# ------------------------------------------------------------ audio decoder
# The MusicGen/EnCodec-style waveform head: 1D K4S2 TDC deconv layers
# (configs.musicgen_medium.audio_decoder) on the 1D engine.  The engine call
# is linear; the bias and activation run after it in PyTorch, where autograd
# differentiates them, and the engine's gradient is Engine1dFn's.

_AUDIO_ACTS = {
    "relu": torch.relu,
    "leaky_relu": L.leaky_relu,
    "tanh": torch.tanh,
    "none": lambda x: x,
}

# impl -> winograd_deconv1d kwargs (the 1D engine); "lax" and "tdc" are the
# baselines on raw weights
_AUDIO_ENGINE_KW: dict[str, dict] = {"cuda": dict(backend="cuda"), "ref": dict(backend="ref")}
AUDIO_IMPLS = ("lax", "tdc", *_AUDIO_ENGINE_KW)


def lax_deconv1d(x: torch.Tensor, w: torch.Tensor, dims: DeconvDims) -> torch.Tensor:
    """The framework's own 1D transposed convolution (``F.conv_transpose1d``,
    as the reference leaves it to XLA): x (B, L, N), w (K_D, N, M) ->
    (B, L_O, M).  The baseline and yardstick; the kernel path never calls it.
    ``conv_transpose1d`` refuses output_padding >= stride; there the
    reference's own form runs: the S-dilated input, padded (K-1-P,
    K-1-P+OP) (a negative pad crops), correlated with the flipped taps."""
    K, S, P, OP = dims.kernel, dims.stride, dims.padding, dims.output_padding
    if OP >= S:
        B, L, N = x.shape
        xd = x.new_zeros((B, S * (L - 1) + 1, N))
        xd[:, ::S] = x
        xd = torch.nn.functional.pad(xd, (0, 0, K - 1 - P, K - 1 - P + OP))  # crops where a pad is negative
        return torch.nn.functional.conv1d(xd.permute(0, 2, 1), w.flip(0).permute(2, 1, 0)).permute(0, 2, 1)
    y = torch.nn.functional.conv_transpose1d(x.permute(0, 2, 1), w.permute(1, 2, 0), stride=dims.stride,
                                             padding=dims.padding, output_padding=dims.output_padding)
    return y.permute(0, 2, 1)


def audio_decoder_init(specs: tuple[Deconv1dSpec, ...], *, seed: int | torch.Generator = 0, device="cuda",
                       dtype=torch.float32) -> Params:
    """Params of a ``Deconv1dSpec`` stack from ``seed`` (an int or a
    ``torch.Generator`` on ``device``): raw (K_D, N, M) taps, N(0, 0.02^2),
    and a zero bias per layer (no batchnorm: audio decoders normalize
    upstream of the waveform head)."""
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=device).manual_seed(seed)
    return {f"deconv{i}": {"w": L.normal_init(gen, (s.dims.kernel, s.c_in, s.c_out), 0.02, dtype),
                           "b": torch.zeros((s.c_out,), dtype=dtype, device=device)}
            for i, s in enumerate(specs)}


def _audio_deconv_apply(impl: str, x: torch.Tensor, w: torch.Tensor, dims: DeconvDims) -> torch.Tensor:
    if impl == "lax":
        return lax_deconv1d(x, w, dims)
    if impl == "tdc":
        return tdc_deconv1d(x, w, dims)
    return kops.winograd_deconv1d(x, w, dims, **_AUDIO_ENGINE_KW[impl])


def audio_decoder_apply(params: Params, specs: tuple[Deconv1dSpec, ...], x: torch.Tensor, *,
                        impl: str = "cuda") -> torch.Tensor:
    """Run the decoder stack: latent (B, L, c_in) -> waveform
    (B, L * prod(strides), c_out).  ``impl``: ``"cuda"`` (the 1D engine's
    kernels for CUDA tensors, their plain versions for CPU tensors; the
    reference's ``"pallas"`` reads as it), ``"ref"`` (the plain 1D engine),
    ``"tdc"`` (the sub-correlation oracle), ``"lax"`` (the framework's
    transposed convolution); all compute the same waveform."""
    impl = PORT_NAMES.get(impl, impl)
    if impl not in AUDIO_IMPLS:
        raise ValueError(f"audio impl {impl!r} is not one of {AUDIO_IMPLS}")
    for i, s in enumerate(specs):
        wd = params[f"deconv{i}"]
        x = _AUDIO_ACTS[s.act](_audio_deconv_apply(impl, x, wd["w"], s.dims) + wd["b"])
    return x
