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

The LM steps split their work over the "model" axis (tensor parallelism,
as GSPMD splits the reference's step under ``lm_param_specs``): each rank
gathers its parameter blocks over the batch axes only, into its "model"
block of each leaf (``sharding.lm_local_specs``; the expert-parallel MoE's
experts stay on their data shard), and computes on it (``parallel/tp.py``).
The train step: this rank's share of ``train_loss(mesh=)`` and its
gradient on those blocks; the gradients summed over the batch axes
(``overlap.reduce_bucketed``; an expert-parallel expert's over "pod"
only), and over "model" for the leaves whose gradient a rank holds partial
(``sharding.lm_grad_partial``); the global norm once, each leaf's square
counted over the ranks whose blocks differ (every rank the same scale);
then AdamW on the blocks (ZeRO).  Prefill and decode return the rank's
``P(batch, "model")`` block of the logits and its cache block.
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


def _gather_tree(tree, specs, local, mesh):
    """Each leaf gathered over the axes its spec names and its ``local``
    spec does not: the rank's model-local block."""
    with torch.no_grad():
        return tree_map(lambda t, sp, kp: SH.gather(t, sp, mesh, keep=kp), tree, specs, local)


def _blocks(tree, specs, local, mesh):
    """The rank's storage blocks of model-local leaves."""
    return tree_map(lambda t, sp, kp: SH.block_of(t, sp, mesh, keep=kp), tree, specs, local)


def _local_axes(spec) -> tuple:
    """The mesh axes a (local) spec names, in the spec's order."""
    return tuple(a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e))


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


def _sum_over(grads: list, group, plan=None) -> list:
    """The leaves summed over ``group`` in buckets (one all-reduce each;
    ``plan`` buckets them by list position)."""
    tree = dict(enumerate(grads))
    out, _ = OV.reduce_bucketed(tree, plan or OV.plan_buckets(tree), group, axis_size=1)
    return [out[i] for i in range(len(grads))]


def _global_norm(grads: list, axes: list, mesh) -> torch.Tensor:
    """The global gradient norm from model-local leaves: each leaf's sum of
    squares summed over the axes its blocks differ on (``axes``, one
    tuple a leaf), so a replicated leaf counts once and a split one once
    a block.  One all-reduce a set of axes, in a fixed order."""
    sums: dict = {}
    for g, ax in zip(grads, axes):
        sq = torch.sum(torch.square(g.float()))
        sums[ax] = sq if ax not in sums else sums[ax] + sq
    total = None
    for ax in sorted(sums):
        sq = sums[ax]
        if mesh.extent(ax) > 1:
            dist.all_reduce(sq, group=mesh.group(ax))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def build_lm_step(cfg: LMConfig, shape: ShapeConfig, mesh, *, readings: Optional[list] = None):
    """The cell's step: ``(fn, arg_structs, meta)`` (see ``lm_input_specs``
    for the signatures and the module docstring for the steps).

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
    args, in_sh, out_sh, meta = lm_input_specs(cfg, shape, mesh)
    meta["in_specs"], meta["out_specs"] = in_sh, out_sh
    pspecs = in_sh[0]
    local = SH.lm_local_specs(cfg, mesh, pspecs)
    axes = SH.MeshAxes.for_mesh(mesh).batch
    split = _split(shape, mesh) and mesh.extent(axes) > 1
    gb = shape.global_batch
    if not _split(shape, mesh):  # every rank takes the whole batch (lm_batch_specs), as GSPMD would
        line = f"batch: {gb} % {axes}({mesh.extent(axes)}) != 0 -> replicated"
        meta["fallbacks"] = meta["fallbacks"] + [line]
        log.warning("sharding fallback: %s", line)

    if shape.mode == "train":
        # per leaf, in the structs' key order (the step puts its leaves in it)
        in_order = lambda tree: tree_leaves(tree_map(lambda _, x: x, args[0], tree))  # noqa: E731
        lspecs = in_order(local)
        partial = in_order(SH.lm_grad_partial(cfg, mesh, pspecs))
        # the batch axes each leaf's gradient sums over: all of them, or an expert-parallel expert's other ones
        sums = [tuple(a for a in axes if a not in _local_axes(kp)) if split else () for kp in lspecs]
        structs = tree_leaves(tree_map(lambda t, kp: SH.block_of(t, kp, mesh), args[0], local))  # model-local
        batch_plan = OV.plan_buckets(dict(enumerate(t for t, a in zip(structs, sums) if a == axes)))
        meta["bucket_plan"] = batch_plan
        norm_axes = [_local_axes(kp) for kp in lspecs]

        def train_step(params, opt, batch):
            lap = _Laps(tree_leaves(params)[0].device) if readings is not None else (lambda name: None)
            full = tree_map(lambda _, x: x.detach().requires_grad_(True), args[0],
                            _gather_tree(params, pspecs, local, mesh))
            lap("gather_ms")
            with torch.enable_grad():
                share, loss = LM.train_loss(full, cfg, batch, q_chunk=cfg.q_chunk, loss_chunk=cfg.loss_chunk,
                                            mesh=mesh, global_batch=gb)
                leaves = tree_leaves(full)
                got = torch.autograd.grad(share, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, got)]
            lap("grad_ms")
            # the shares' gradients sum over the batch axes (axis_size 1: a sum, not a mean)
            for ax in sorted(a for a in set(sums) if a and mesh.extent(a) > 1):
                idx = [i for i, a in enumerate(sums) if a == ax]
                for i, g in zip(idx, _sum_over([grads[i] for i in idx], mesh.group(ax),
                                               batch_plan if ax == axes else None)):
                    grads[i] = g
            idx = [i for i, p in enumerate(partial) if p]  # each model rank holds a partial sum of these
            if idx:
                for i, g in zip(idx, _sum_over([grads[i] for i in idx], mesh.group("model"))):
                    grads[i] = g
            lap("reduce_ms")
            gn = _global_norm(grads, norm_axes, mesh)  # every rank the same norm and scale
            it = iter(grads)
            grads, _ = clip_by_global_norm(tree_map(lambda _: next(it), full), LM_MAX_GRAD_NORM, gn)
            detach = lambda tree: tree_map(torch.Tensor.detach, tree)  # noqa: E731
            new_p, new_o, _ = adamw_update(_blocks(detach(full), pspecs, local, mesh),
                                           _blocks(grads, pspecs, local, mesh), opt, lr=LM_LR)
            lap("update_ms")
            if readings is not None:
                readings.append(dict(lap, grad_norm=float(gn), loss=float(loss)))
            return new_p, new_o, loss

        return train_step, args, meta

    if shape.mode == "prefill":

        def prefill_step(params, batch):
            with torch.no_grad():
                return LM.prefill(_gather_tree(params, pspecs, local, mesh), cfg, batch, q_chunk=cfg.q_chunk,
                                  max_len=shape.seq_len + 1, mesh=mesh, global_batch=gb)

        return prefill_step, args, meta

    seq_shard = meta["seq_shard"]
    # the reference's serve step runs decode_step without a mesh unless sequence-sharded: its MoE is then
    # moe_apply on the global batch, never the expert-parallel one (every expert gathered over the batch axes)
    dcfg = cfg if seq_shard else dataclasses.replace(cfg, moe_ep=False)
    local = SH.lm_local_specs(dcfg, mesh, pspecs)

    def serve_step(params, cache, batch, cache_len):
        tok = batch["tokens"] if "tokens" in batch else batch["embeds"]
        with torch.no_grad():
            return LM.decode_step(_gather_tree(params, pspecs, local, mesh), dcfg, cache, tok, cache_len, mesh=mesh,
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
    reference's deprecated spelling.  ``meta["in_specs"]`` holds the
    structs' specs, in their order."""
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
        meta["in_specs"] = (*meta["specs"], *(() if comm == () else (meta["comm_specs"],)), *meta["batch_specs"])
        return fn, (gp, dp, *opts, *comm, z, real), meta
    fn, meta = OV.build_gan_mesh_step(cfg, mesh, batch=batch, lr=st.lr, b1=st.b1, dtype=PARAM_DTYPE)
    meta["in_specs"] = (*meta["specs"], *meta["batch_specs"])
    return fn, (gp, dp, *opts, z, real), meta


def build_step(arch: str, shape_name: str, mesh):
    """The step of ``arch`` (a GAN's train step, or an LM's at
    ``SHAPES[shape_name]``) on ``mesh``: ``(fn, arg_structs, meta)``."""
    cfg = get_config(arch)
    if isinstance(cfg, GANConfig):
        return build_gan_step(cfg, mesh)
    return build_lm_step(cfg, SHAPES[shape_name], mesh)
