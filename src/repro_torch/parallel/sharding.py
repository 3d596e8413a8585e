"""Sharding rules for the GAN and the LM trees (the reference's
``parallel/sharding.py``), and the placement helpers that turn them into
per-rank blocks.

A leaf's placement is its reference ``PartitionSpec``: one entry per
dimension, ``None`` (replicated) or a mesh axis name or tuple of names
(split over those axes, major to minor).  The port's ``PartitionSpec`` is a
tuple subclass with the same (canonical) entries, so a spec compares equal
to ``tuple(jax_spec)``.

The rules are divisibility-aware, as the reference's: a dimension is split
on an axis only when the axis's extent divides it; otherwise it is
replicated and the fallback is recorded in the spec fallback log, in the
reference's words ("deconv3.M: 3 % model(2) != 0 -> replicated").

Storage versus compute: a parameter or an AdamW moment lives as each
rank's block of it (``block_of``; ZeRO, as the reference's out-specs leave
them), and a step gathers the full leaf once on entry (``gather``: an
``all_gather`` over each axis the spec names, minor axis first, so the
blocks concatenate in the reference's major-to-minor order and round-trip).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import GANConfig, LMConfig, ShapeConfig
from ..optim import OptState

__all__ = ["PartitionSpec", "P", "MeshAxes", "SpecBuilder", "Placement", "gan_param_specs", "gan_batch_specs",
           "audio_decoder_param_specs", "lm_param_specs", "lm_batch_specs", "cache_specs", "opt_specs", "named",
           "block_of", "gather", "map_specs"]


class PartitionSpec(tuple):
    """A leaf's placement: per dimension ``None`` or mesh axis name(s).  A
    one-name tuple is stored as the name, as JAX's ``PartitionSpec``
    canonicalizes it (the block layout is the same)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    batch: tuple[str, ...]  # activation batch axes, e.g. ("pod", "data")
    fsdp: tuple[str, ...]  # weight FSDP axes (the batch axes)
    tp: str = "model"

    @staticmethod
    def for_mesh(mesh) -> "MeshAxes":
        batch = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
        return MeshAxes(batch=batch, fsdp=batch)


def _axis_tuple(ax) -> tuple[str, ...]:
    return ax if isinstance(ax, tuple) else (ax,)


def _size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


class SpecBuilder:
    """Divisibility-aware spec construction with a fallback log."""

    def __init__(self, mesh, axes: MeshAxes):
        self.mesh, self.axes = mesh, axes
        self.fallbacks: list[str] = []

    def dim(self, name: str, size: int, axis) -> Optional[Any]:
        """axis: str | tuple | None -> axis if its extent divides ``size``,
        else None (and a line in the fallback log)."""
        if axis is None:
            return None
        n = _size(self.mesh, axis)
        if size % n == 0:
            return axis
        self.fallbacks.append(f"{name}: {size} % {axis}({n}) != 0 -> replicated")
        return None


def _tp_or_none(mesh, axes: MeshAxes) -> Optional[str]:
    """The TP axis name, or None when the mesh has no such axis (the
    pure-data meshes)."""
    return axes.tp if axes.tp in mesh.axis_names else None


def gan_param_specs(cfg: GANConfig, mesh, axes: Optional[MeshAxes] = None):
    """Spec trees matching ``generator_init`` / ``discriminator_init``:
    ``(gen_specs, disc_specs, fallback_log)``.

    Packed (C, N, M) ``ww`` leaves split N over the batch (FSDP) axes and M
    over "model" (TP) where they divide, C replicated (the engine's grid runs
    over it); raw (K, K, N, M) deconv weights and the discriminator's convs
    split their trailing channel dims the same way; batchnorm leaves are
    replicated.  Every generator's last layer has M = img_ch = 3, which no
    TP degree divides: it replicates, and the log says so."""
    from ..models import gan as G  # lazily: the specs need no kernel

    axes = axes or MeshAxes.for_mesh(mesh)
    b = SpecBuilder(mesh, axes)
    fsdp = axes.fsdp
    tp = _tp_or_none(mesh, axes)
    prepacked = G.uses_prepacked(cfg.deconv_impl)
    prepacked_conv = G.uses_prepacked_conv(getattr(cfg, "conv_impl", "lax"))

    def bn_spec():
        return {"scale": P(None), "bias": P(None), "mean": P(None), "var": P(None)}

    def conv_spec(prefix, c_in, c_out):
        return {
            "w": P(None, None, b.dim(f"{prefix}.in", c_in, fsdp), b.dim(f"{prefix}.out", c_out, tp)),
            "b": P(b.dim(f"{prefix}.b", c_out, tp)),
        }

    gen: dict[str, Any] = {}
    if cfg.z_dim:
        d_out = cfg.seed_hw**2 * cfg.stem_ch
        gen["stem"] = {
            "w": P(b.dim("stem.in", cfg.z_dim, fsdp), b.dim("stem.out", d_out, tp)),
            "b": P(b.dim("stem.b", d_out, tp)),
        }
        gen["stem_bn"] = bn_spec()
    for i, e in enumerate(cfg.encoder):
        gen[f"enc{i}"] = conv_spec(f"enc{i}", e.c_in, e.c_out)
        if e.norm == "batch":
            gen[f"enc{i}_bn"] = bn_spec()
    for i, d in enumerate(cfg.deconvs):
        n_ax = b.dim(f"deconv{i}.N", d.c_in, fsdp)
        m_ax = b.dim(f"deconv{i}.M", d.c_out, tp)
        gen[f"deconv{i}"] = {"ww": P(None, n_ax, m_ax)} if prepacked else {"w": P(None, None, n_ax, m_ax)}
        if d.norm == "batch":
            gen[f"deconv{i}_bn"] = bn_spec()

    disc: dict[str, Any] = {}
    chans = (cfg.img_ch,) + G.disc_channels(cfg)
    for i in range(len(chans) - 1):
        if prepacked_conv:
            disc[f"conv{i}"] = {
                "ww": P(None, b.dim(f"disc.conv{i}.N", chans[i], fsdp), b.dim(f"disc.conv{i}.M", chans[i + 1], tp)),
                "b": P(b.dim(f"disc.conv{i}.b", chans[i + 1], tp)),
            }
        else:
            disc[f"conv{i}"] = conv_spec(f"disc.conv{i}", chans[i], chans[i + 1])
        if i > 0:
            disc[f"conv{i}_bn"] = bn_spec()
    final_hw = cfg.img_hw // 2 ** (len(chans) - 1)
    disc["head"] = {
        "w": P(b.dim("disc.head.in", final_hw**2 * chans[-1], fsdp), None),
        "b": P(None),  # one logit: never split, not worth a log line
    }
    return gen, disc, b.fallbacks


def audio_decoder_param_specs(specs, mesh, axes: Optional[MeshAxes] = None, packed: bool = False):
    """Spec tree matching ``audio_decoder_init`` (raw (K_D, N, M) taps) or,
    with ``packed``, its Winograd-domain (C, N, M) ``ww`` form: FSDP over N,
    TP over M where they divide, the leading axis replicated.  Returns
    (specs_tree, fallback_log)."""
    axes = axes or MeshAxes.for_mesh(mesh)
    b = SpecBuilder(mesh, axes)
    tp = _tp_or_none(mesh, axes)
    sp: dict[str, Any] = {}
    for i, s in enumerate(specs):
        n_ax = b.dim(f"audio.deconv{i}.N", s.c_in, axes.fsdp)
        m_ax = b.dim(f"audio.deconv{i}.M", s.c_out, tp)
        sp[f"deconv{i}"] = {"ww" if packed else "w": P(None, n_ax, m_ax),
                            "b": P(b.dim(f"audio.deconv{i}.b", s.c_out, tp))}
    return sp, b.fallbacks


def gan_batch_specs(cfg: GANConfig, batch: int, mesh, axes: Optional[MeshAxes] = None):
    """Specs of the GAN train batch: (z_or_image_spec, real_spec, fallbacks).
    The batch dimension splits over the batch axes when ``batch`` divides
    their extent; otherwise both inputs replicate (and the log says so)."""
    axes = axes or MeshAxes.for_mesh(mesh)
    b = SpecBuilder(mesh, axes)
    bax = b.dim("gan.batch", batch, axes.batch)
    z = P(bax, None) if cfg.z_dim else P(bax, None, None, None)
    return z, P(bax, None, None, None), b.fallbacks


def _need_model_axis(mesh, axes: MeshAxes) -> None:
    """An LM mesh always has a TP axis (``launch.train --smoke`` builds
    (1, 1) ("data", "model")); the LM rules read its extent unguarded."""
    if axes.tp not in mesh.axis_names:
        raise ValueError(f"an LM mesh needs a {axes.tp!r} axis (extent 1 will do); this one has {mesh.axis_names}")


def lm_param_specs(cfg: LMConfig, mesh, axes: Optional[MeshAxes] = None):
    """Spec tree matching ``lm_init(cfg)`` exactly: ``(specs, fallback_log)``.

    Megatron TP on "model" over each weight's feature dimension and FSDP on
    the batch axes over the other, the leading n_super axis replicated;
    attention and ``in_dt`` fall back to replicated heads where the head
    count does not divide the TP extent (one log line), the MoE's experts
    replicate (FSDP carries them) unless ``cfg.moe_ep`` puts one expert a
    "data" shard (and D unsplit)."""
    from ..models import lm as LM  # lazily: the models import no parallel code

    axes = axes or MeshAxes.for_mesh(mesh)
    _need_model_axis(mesh, axes)
    b = SpecBuilder(mesh, axes)
    tp, fsdp = axes.tp, axes.fsdp
    D, V = cfg.d_model, cfg.vocab
    hd = cfg.hd

    def lin(prefix, d_in, d_out, in_ax, out_ax, bias_key=False):
        spec = {"w": P(None, b.dim(f"{prefix}.in", d_in, in_ax), b.dim(f"{prefix}.out", d_out, out_ax))}
        if bias_key:
            spec["b"] = P(None, b.dim(f"{prefix}.b", d_out, out_ax))
        return spec

    def norm_spec(stacked=True):
        lead = (None,) if stacked else ()
        base = {"scale": P(*lead, None)}
        if cfg.norm == "layernorm":
            base["bias"] = P(*lead, None)
        return base

    specs: dict[str, Any] = {"embed": {"table": P(b.dim("embed.V", V, tp), None)},
                             "final_norm": norm_spec(stacked=False)}
    if not cfg.tie_embeddings:
        specs["head"] = {"w": P(b.dim("head.D", D, fsdp), b.dim("head.V", V, tp))}
    blocks: dict[str, Any] = {}
    for i, sp in enumerate(LM.slot_specs(cfg)):
        s: dict[str, Any] = {"norm1": norm_spec()}
        if sp.kind == "attn":
            h_ax = tp if cfg.n_heads % _size(mesh, tp) == 0 else None
            kv_ax = tp if cfg.n_kv_heads % _size(mesh, tp) == 0 else None
            if h_ax is None:
                b.fallbacks.append(f"slot{i}.attn: {cfg.n_heads} heads !% tp -> replicated attn")
            s["attn"] = {
                "wq": lin("wq", D, cfg.n_heads * hd, fsdp, h_ax),
                "wk": lin("wk", D, cfg.n_kv_heads * hd, fsdp, kv_ax),
                "wv": lin("wv", D, cfg.n_kv_heads * hd, fsdp, kv_ax),
                "wo": lin("wo", cfg.n_heads * hd, D, h_ax, fsdp),
            }
        else:
            ssm = cfg.ssm
            d_inner = ssm.expand * D
            H = d_inner // ssm.head_dim
            s["mamba"] = {
                "in_z": lin("in_z", D, d_inner, fsdp, tp),
                "in_x": lin("in_x", D, d_inner, fsdp, tp),
                "in_B": lin("in_B", D, ssm.d_state, fsdp, None),
                "in_C": lin("in_C", D, ssm.d_state, fsdp, None),
                "in_dt": lin("in_dt", D, H, fsdp, tp if H % _size(mesh, tp) == 0 else None),
                "conv_x": {"w": P(None, None, b.dim("conv_x", d_inner, tp)),
                           "b": P(None, b.dim("conv_xb", d_inner, tp))},
                "conv_B": {"w": P(None, None, None), "b": P(None, None)},
                "conv_C": {"w": P(None, None, None), "b": P(None, None)},
                "A_log": P(None, b.dim("A_log", H, tp)),
                "D": P(None, b.dim("ssm.D", H, tp)),
                "dt_bias": P(None, b.dim("dt_bias", H, tp)),
                "norm": {"scale": P(None, b.dim("ssm.norm", d_inner, tp))},
                "out_proj": lin("out_proj", d_inner, D, tp, fsdp),
            }
        if sp.ffn == "mlp":
            s["norm2"] = norm_spec()
            glu = cfg.mlp in ("swiglu", "geglu")
            mspec = {"up": lin("mlp.up", D, cfg.d_ff, fsdp, tp, bias_key=not glu),
                     "down": lin("mlp.down", cfg.d_ff, D, tp, fsdp, bias_key=not glu)}
            if glu:
                mspec["gate"] = lin("mlp.gate", D, cfg.d_ff, fsdp, tp)
            s["mlp"] = mspec
        elif sp.ffn == "moe":
            s["norm2"] = norm_spec()
            E = cfg.moe.num_experts
            e_ax = None  # experts replicated (FSDP carries them)
            if cfg.moe_ep:  # one expert (group) a data shard; FSDP moves to the expert dim
                e_ax = "data" if E % mesh.shape["data"] == 0 else None
                if e_ax is None:
                    b.fallbacks.append(f"moe_ep: E={E} !% data -> replicated experts")
            d_ax = None if cfg.moe_ep else fsdp
            ms: dict[str, Any] = {
                "router": {"w": P(None, b.dim("router.D", D, d_ax), None)},
                "up": {"w": P(None, e_ax, b.dim("moe.up.D", D, d_ax), b.dim("moe.up.ff", cfg.d_ff, tp))},
                "down": {"w": P(None, e_ax, b.dim("moe.dn.ff", cfg.d_ff, tp), b.dim("moe.dn.D", D, d_ax))},
            }
            if cfg.mlp in ("swiglu", "geglu"):
                ms["gate"] = {"w": P(None, e_ax, b.dim("moe.gt.D", D, d_ax), b.dim("moe.gt.ff", cfg.d_ff, tp))}
            s["moe"] = ms
        blocks[f"slot{i}"] = s
    specs["blocks"] = blocks
    return specs, b.fallbacks


def _lm_batch_axis(shape: ShapeConfig, mesh, axes: MeshAxes):
    """The batch axes when the global batch divides their extent, else None
    (replicated inputs)."""
    return axes.batch if shape.global_batch % _size(mesh, axes.batch) == 0 else None


def lm_batch_specs(cfg: LMConfig, shape: ShapeConfig, mesh, axes: Optional[MeshAxes] = None) -> dict:
    """Specs of the input batch dict: rows over the batch axes when the
    global batch divides their extent, else replicated."""
    axes = axes or MeshAxes.for_mesh(mesh)
    _need_model_axis(mesh, axes)
    batch_ax = _lm_batch_axis(shape, mesh, axes)
    sp: dict[str, Any] = {}
    if cfg.frontend == "stub_embeds":
        sp["embeds"] = P(batch_ax, None, None)
    else:
        sp["tokens"] = P(batch_ax, None)
    if shape.mode == "train":
        sp["labels"] = P(batch_ax, None)
    if cfg.mrope_sections is not None:
        sp["positions"] = P(batch_ax, None, None)
    return sp


def cache_specs(cfg: LMConfig, shape: ShapeConfig, mesh, axes: Optional[MeshAxes] = None, seq_shard: bool = False):
    """Specs of the decode cache (``lm.init_cache``'s layout): rows over the
    batch axes where the global batch divides, kv heads / SSM heads and
    channels over "model" where they divide; ``seq_shard`` splits the
    global (non-local) attention caches' sequence over "data"."""
    from ..models import lm as LM
    from ..models.ssm import SSMCache

    axes = axes or MeshAxes.for_mesh(mesh)
    _need_model_axis(mesh, axes)
    batch_ax = _lm_batch_axis(shape, mesh, axes)
    tp = axes.tp
    kv_ax = tp if cfg.n_kv_heads and cfg.n_kv_heads % _size(mesh, tp) == 0 else None
    specs = {}
    for i, sp in enumerate(LM.slot_specs(cfg)):
        if sp.kind == "attn":
            local = sp.attn_kind == "local" and cfg.window
            seq_ax = "data" if (seq_shard and not local) else None
            specs[f"slot{i}"] = LM.AttnCache(k=P(None, batch_ax, seq_ax, kv_ax, None),
                                             v=P(None, batch_ax, seq_ax, kv_ax, None), pos=P(None, batch_ax, seq_ax))
        else:
            d_inner = cfg.ssm.expand * cfg.d_model
            H = d_inner // cfg.ssm.head_dim
            h_ax = tp if H % _size(mesh, tp) == 0 else None
            di_ax = tp if d_inner % _size(mesh, tp) == 0 else None
            specs[f"slot{i}"] = SSMCache(conv_x=P(None, batch_ax, None, di_ax), conv_B=P(None, batch_ax, None, None),
                                         conv_C=P(None, batch_ax, None, None), state=P(None, batch_ax, h_ax, None, None))
    return specs


def opt_specs(param_specs) -> OptState:
    """AdamW's moments mirror the parameter specs (ZeRO-sharded moments)."""
    return OptState(step=P(), m=param_specs, v=param_specs)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives: its spec on a mesh (``named`` builds trees of
    them; the checkpoints' ``shardings=`` takes such a tree)."""

    mesh: Any
    spec: PartitionSpec


def map_specs(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree (nested dicts and NamedTuples: an
    ``OptState``, the caches) and its spec tree; an ``OptState``'s int
    ``step`` passes through."""
    if isinstance(spec_tree, PartitionSpec) or isinstance(spec_tree, Placement):
        return tree if isinstance(tree, int) else fn(tree, spec_tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, t, s) for t, s in zip(tree, spec_tree)))
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, spec_tree[k]) for k, v in tree.items()}
    raise TypeError(f"no spec rule for a {type(tree).__name__}")


def named(mesh, spec_tree):
    """The spec tree as a tree of ``Placement``s on ``mesh``."""
    if isinstance(spec_tree, PartitionSpec):
        return Placement(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple):  # NamedTuples (OptState, CommState) keep their type
        out = [named(mesh, v) for v in spec_tree]
        return type(spec_tree)(*out) if hasattr(spec_tree, "_fields") else tuple(out)
    raise TypeError(f"no spec rule for a {type(spec_tree).__name__}")


def block_of(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full array ``leaf`` under ``spec`` (a copy of
    its own when it is a slice, so that the full array can be freed).  The
    block index over a dimension's axes is row-major, major axis first, as
    the reference's ``axis_index`` arithmetic; no collective runs."""
    out = leaf
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        names = _axis_tuple(ax)
        n = _size(mesh, names)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(leaf.shape)} does not split over {names} ({n} ranks)")
        blk = out.shape[dim] // n
        out = out.narrow(dim, mesh.index(names) * blk, blk)
    return leaf if out is leaf else out.clone(memory_format=torch.contiguous_format)


def gather(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full array from every rank's ``block`` under ``spec``: an
    ``all_gather`` over each axis the spec names, minor axis first (the
    inverse of ``block_of``).  Every rank of the mesh calls it, in the same
    order of leaves."""
    out = block
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in reversed(_axis_tuple(ax)):
            n = mesh.shape[a]
            if n == 1:
                continue
            parts = [torch.empty_like(out) for _ in range(n)]
            dist.all_gather(parts, out.contiguous(), group=mesh.group(a))
            out = torch.cat(parts, dim=dim)
    return out
