"""Step functions and their argument structs for every (arch x shape) cell
(the reference's ``launch/steps.py``), on ``torch.distributed`` with one
process a rank.

``lm_input_specs`` / ``gan_input_specs`` give the global arguments as
meta-device tensors (PyTorch's counterpart of ``ShapeDtypeStruct``: shapes
and dtypes, no storage) at the reference's ``PARAM_DTYPE``, with their
``PartitionSpec`` trees.  ``build_step`` returns the callable every rank
of the mesh calls together; each argument is the rank's block of the
global one under its spec (``parallel.sharding.block_of``), and each
result the rank's block of the reference's.  The caller's parameters set
the dtype the step runs in.

The LM train step: gather the parameter blocks once on entry, this rank's
share of ``train_loss(mesh=)`` and its gradient, the gradients summed over
the batch axes (``overlap.reduce_bucketed``), the global norm clipped once
from the full reduced gradient (every rank the same scale), then AdamW on
the blocks (ZeRO).  The model axis is storage only.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..configs import SHAPES, get_config
from ..configs.base import GANConfig, LMConfig, ShapeConfig
from ..models import lm as LM
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..parallel import overlap as OV
from ..parallel import sharding as SH
from ..tree import tree_leaves, tree_map

__all__ = ["PARAM_DTYPE", "GAN_TRAIN_BATCH", "LM_LR", "LM_MAX_GRAD_NORM", "lm_input_specs", "build_lm_step",
           "gan_input_specs", "build_gan_step", "build_step"]

log = logging.getLogger("repro_torch.launch")

PARAM_DTYPE = torch.bfloat16
GAN_TRAIN_BATCH = 256
LM_LR, LM_MAX_GRAD_NORM = 3e-4, 1.0


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------- LM steps
def _batch_structs(cfg: LMConfig, shape: ShapeConfig) -> dict:
    B, T = shape.global_batch, shape.seq_len
    T = 1 if shape.mode == "decode" else T
    b: dict[str, Any] = {}
    if cfg.frontend == "stub_embeds":
        b["embeds"] = _struct((B, T, cfg.d_model), PARAM_DTYPE)
    else:
        b["tokens"] = _struct((B, T), torch.int32)
    if shape.mode == "decode":
        return b
    if shape.mode == "train":
        b["labels"] = _struct((B, T), torch.int32)
    if cfg.mrope_sections is not None:
        b["positions"] = _struct((B, T, 3), torch.int32)
    return b


def _split(shape: ShapeConfig, mesh) -> bool:
    """Whether the global batch splits over the mesh's batch axes."""
    axes = SH.MeshAxes.for_mesh(mesh).batch
    return shape.global_batch % mesh.extent(axes) == 0


def lm_input_specs(cfg: LMConfig, shape: ShapeConfig, mesh):
    """``(arg_structs, in_specs, out_specs, meta)`` for the cell: train
    ``(params, opt, batch) -> (params, opt, loss)``, prefill ``(params,
    batch) -> (logits, cache)``, decode ``(params, cache, batch, cache_len)
    -> (logits, cache)``.  ``meta``: the fallback log, and for decode
    whether the cache is sequence-sharded (the ``long_500k`` shape)."""
    axes = SH.MeshAxes.for_mesh(mesh)
    pspecs, fallbacks = SH.lm_param_specs(cfg, mesh, axes)
    params_struct = LM.lm_init(cfg, device="meta", dtype=PARAM_DTYPE)
    meta: dict[str, Any] = {"fallbacks": fallbacks}
    if shape.mode == "train":
        args = (params_struct, adamw_init(params_struct), _batch_structs(cfg, shape))
        ospecs = SH.opt_specs(pspecs)
        return args, (pspecs, ospecs, SH.lm_batch_specs(cfg, shape, mesh, axes)), (pspecs, ospecs, SH.P()), meta
    batch_ax = axes.batch if _split(shape, mesh) else None
    logits_spec = SH.P(batch_ax, axes.tp if cfg.vocab % mesh.shape[axes.tp] == 0 else None)
    if shape.mode == "prefill":
        cspecs = SH.cache_specs(cfg, shape, mesh, axes)
        return ((params_struct, _batch_structs(cfg, shape)), (pspecs, SH.lm_batch_specs(cfg, shape, mesh, axes)),
                (logits_spec, cspecs), meta)
    seq_shard = shape.name == "long_500k"
    cache_struct = LM.init_cache(cfg, shape.global_batch, shape.seq_len, PARAM_DTYPE, device="meta")
    cspecs = SH.cache_specs(cfg, shape, mesh, axes, seq_shard=seq_shard)
    bspecs = {k: SH.P(batch_ax, *(None,) * (t.dim() - 1)) for k, t in _batch_structs(cfg, shape).items()}
    args = (params_struct, cache_struct, _batch_structs(cfg, shape), _struct((), torch.int32))
    meta["seq_shard"] = seq_shard
    return args, (pspecs, cspecs, bspecs, SH.P()), (logits_spec, cspecs), meta


def _gather_tree(tree, specs, mesh):
    with torch.no_grad():
        return SH.map_specs(lambda t, sp: SH.gather(t, sp, mesh), tree, specs)


def _blocks(tree, specs, mesh):
    return SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), tree, specs)


class _Laps(dict):
    """The ms since the previous lap under each name, the device
    synchronized at every lap (a measurement mode)."""

    def __init__(self, device):
        super().__init__()
        self.device = device
        self.t = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, name: str) -> None:
        now = self._now()
        self[name], self.t = 1e3 * (now - self.t), now


def _ep_partial_leaves(cfg: LMConfig, mesh) -> list:
    """Key paths of the leaves whose gradient a rank leaves partial over
    "model": the expert-parallel MoE's expert weights, each rank computing
    its ``ff`` slice only."""
    if not cfg.moe_ep or mesh.shape["model"] == 1:
        return []
    return [("blocks", f"slot{i}", "moe", name) for i, sp in enumerate(LM.slot_specs(cfg)) if sp.ffn == "moe"
            for name in ("up", "down", "gate") if name != "gate" or cfg.mlp in ("swiglu", "geglu")]


def build_lm_step(cfg: LMConfig, shape: ShapeConfig, mesh, *, readings: Optional[list] = None):
    """The cell's step: ``(fn, arg_structs, meta)`` (see ``lm_input_specs``
    for the signatures and the module docstring for the train step).

    train    AdamW at lr 3e-4 and ``max_grad_norm`` 1.0 on the blocks of
             ``value_and_grad(train_loss(mesh=))``; returns the global loss.
    prefill  ``prefill(mesh=)`` with ``max_len = seq_len + 1``.
    decode   ``decode_step(mesh=)``, sequence-sharded over "data" exactly
             for ``long_500k``; elsewhere its MoE is the global batch's
             ``moe_apply``, as the reference's serve step runs it without a
             mesh.

    ``readings`` (a list): each train step appends its global gradient
    norm and, with the device synchronized between them, the ms of its
    gather, forward and backward, reduction and update (a measurement
    mode)."""
    args, in_sh, _, meta = lm_input_specs(cfg, shape, mesh)
    pspecs = in_sh[0]
    axes = SH.MeshAxes.for_mesh(mesh).batch
    split = _split(shape, mesh) and mesh.extent(axes) > 1
    gb = shape.global_batch
    if not _split(shape, mesh):  # every rank takes the whole batch (lm_batch_specs), as GSPMD would
        line = f"batch: {gb} % {axes}({mesh.extent(axes)}) != 0 -> replicated"
        meta["fallbacks"] = meta["fallbacks"] + [line]
        log.warning("sharding fallback: %s", line)

    if shape.mode == "train":
        plan = OV.plan_buckets(args[0])
        partial = _ep_partial_leaves(cfg, mesh)
        meta["bucket_plan"] = plan

        def train_step(params, opt, batch):
            lap = _Laps(tree_leaves(params)[0].device) if readings is not None else (lambda name: None)
            full = tree_map(lambda x: x.detach().requires_grad_(True), _gather_tree(params, pspecs, mesh))
            lap("gather_ms")
            with torch.enable_grad():
                share, loss = LM.train_loss(full, cfg, batch, q_chunk=cfg.q_chunk, loss_chunk=cfg.loss_chunk,
                                            mesh=mesh, global_batch=gb)
                leaves = tree_leaves(full)
                got = torch.autograd.grad(share, leaves, allow_unused=True)
            it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, got))
            grads = tree_map(lambda _: next(it), full)
            lap("grad_ms")
            if split:  # the shares' gradients sum over the batch axes (axis_size 1: a sum, not a mean)
                grads, _ = OV.reduce_bucketed(grads, plan, mesh.group(axes), axis_size=1)
            for path in partial:  # each model rank holds its ff slice's gradient, zeros elsewhere
                leaf = grads
                for k in path:
                    leaf = leaf[k]
                dist.all_reduce(leaf["w"], group=mesh.group("model"))
            lap("reduce_ms")
            # the clip from the full reduced gradient: every rank the same norm and scale
            grads, gn = clip_by_global_norm(grads, LM_MAX_GRAD_NORM)
            detach = lambda tree: tree_map(torch.Tensor.detach, tree)  # noqa: E731
            new_p, new_o, _ = adamw_update(_blocks(detach(full), pspecs, mesh), _blocks(grads, pspecs, mesh), opt,
                                           lr=LM_LR)
            lap("update_ms")
            if readings is not None:
                readings.append(dict(lap, grad_norm=float(gn), loss=float(loss)))
            return new_p, new_o, loss

        return train_step, args, meta

    if shape.mode == "prefill":

        def prefill_step(params, batch):
            with torch.no_grad():
                return LM.prefill(_gather_tree(params, pspecs, mesh), cfg, batch, q_chunk=cfg.q_chunk,
                                  max_len=shape.seq_len + 1, mesh=mesh, global_batch=gb)

        return prefill_step, args, meta

    seq_shard = meta["seq_shard"]
    # the reference's serve step runs decode_step without a mesh unless sequence-sharded: its MoE is then
    # moe_apply on the global batch, never the expert-parallel one
    dcfg = cfg if seq_shard else dataclasses.replace(cfg, moe_ep=False)

    def serve_step(params, cache, batch, cache_len):
        tok = batch["tokens"] if "tokens" in batch else batch["embeds"]
        with torch.no_grad():
            return LM.decode_step(_gather_tree(params, pspecs, mesh), dcfg, cache, tok, cache_len, mesh=mesh,
                                  seq_shard_axis="data" if seq_shard else None, global_batch=gb)

    return serve_step, args, meta


# ------------------------------------------------------------ GAN steps
def gan_input_specs(cfg: GANConfig, mesh, batch: int = GAN_TRAIN_BATCH):
    """``((gp, dp, z, real), (gspecs, dspecs, zspec, rspec), meta)``: the
    GAN train step's structs and specs (the divisibility-aware rules of
    ``parallel.sharding``), ``meta`` its fallback log."""
    gp, dp = OV.param_structs(cfg, PARAM_DTYPE)
    gspecs, dspecs, fallbacks = SH.gan_param_specs(cfg, mesh)
    zspec, rspec, bfb = SH.gan_batch_specs(cfg, batch, mesh)
    z = _struct((batch, cfg.z_dim), PARAM_DTYPE) if cfg.z_dim else \
        _struct((batch, cfg.img_hw, cfg.img_hw, 3), PARAM_DTYPE)
    real = _struct((batch, cfg.img_hw, cfg.img_hw, 3), PARAM_DTYPE)
    return (gp, dp, z, real), (gspecs, dspecs, zspec, rspec), {"fallbacks": fallbacks + bfb}


def build_gan_step(cfg: GANConfig, mesh, *, settings=None, overlap=None, grad_compression=None, bucket_bytes=None):
    """The sharded GAN train step: ``(fn, arg_structs, meta)``.  By default
    ``overlap.build_gan_mesh_step`` (the reference's GSPMD step);
    ``settings.overlap`` or a ``grad_compression`` select
    ``overlap.build_gan_comm_step``, and with int8 the structs gain a
    ``CommState`` of residual rows between the optimizer states and the
    batch.  ``settings=StepSettings(...)`` carries the knobs (``batch``
    defaults to ``GAN_TRAIN_BATCH``); the keyword arguments are the
    reference's deprecated spelling."""
    from ..train.trainer import _UNSET, _merge_legacy

    st = _merge_legacy(settings, dict(overlap=_UNSET if overlap is None else overlap,
                                      grad_compression=_UNSET if grad_compression is None else grad_compression,
                                      bucket_bytes=_UNSET if bucket_bytes is None else bucket_bytes),
                       "build_gan_step")
    cfg = st.apply_to_cfg(cfg)
    batch = st.batch if st.batch is not None else GAN_TRAIN_BATCH
    (gp, dp, z, real), _, _ = gan_input_specs(cfg, mesh, batch)
    opts = (adamw_init(gp), adamw_init(dp))
    if st.comm:
        kw = {} if st.bucket_bytes is None else {"bucket_bytes": st.bucket_bytes}
        fn, meta = OV.build_gan_comm_step(cfg, mesh, batch=batch, lr=st.lr, b1=st.b1,
                                          grad_compression=st.grad_compression, dtype=PARAM_DTYPE, **kw)
        comm = meta["comm_struct"]
        comm = () if comm is None else (OV.CommState(*(tuple(_struct(s, torch.float32) for s in shapes)
                                                       for shapes in comm)),)
        return fn, (gp, dp, *opts, *comm, z, real), meta
    fn, meta = OV.build_gan_mesh_step(cfg, mesh, batch=batch, lr=st.lr, b1=st.b1, dtype=PARAM_DTYPE)
    return fn, (gp, dp, *opts, z, real), meta


def build_step(arch: str, shape_name: str, mesh):
    """The step of ``arch`` (a GAN's train step, or an LM's at
    ``SHAPES[shape_name]``) on ``mesh``: ``(fn, arg_structs, meta)``."""
    cfg = get_config(arch)
    if isinstance(cfg, GANConfig):
        return build_gan_step(cfg, mesh)
    return build_lm_step(cfg, SHAPES[shape_name], mesh)
