"""Bucketed, optionally int8-compressed gradient reduction and the sharded
GAN train steps (the reference's ``parallel/overlap.py``), on
``torch.distributed``: one process per rank, explicit collectives.

The sharded step, as each rank runs it on its rows of the global batch:

  * **gather once on entry**: parameters live as each rank's block
    (``sharding.block_of`` under ``gan_param_specs``); the step
    all-gathers every split leaf once, before the first layer needs it
    (the reference's prefetched FSDP gather with ``P()`` in-specs);
  * **one shared forward, two pulls** (``trainer.make_gan_step``'s
    structure) under ``layers.bn_sync_axis``: training-mode batch
    statistics are averaged over the batch axes, so the step computes the
    single-device function (sync-BN; equal shards);
  * **bucketed reduction**: gradient leaves are packed into size-targeted
    buckets in reverse flatten order (the backward produces the last
    layer's gradients first), one ``all_reduce`` per bucket, issued in plan
    order with ``async_op=True`` so that the reductions queue back to back
    and the flattening of the next bucket overlaps the wire; the
    discriminator's buckets first, then the generator's;
  * **int8 compression with error feedback** (``grad_compression="int8"``):
    each bucket through ``compression.compressed_psum`` (one scale a
    bucket), its residual row carried to the next step in a ``CommState``;
  * **ZeRO block updates**: AdamW's moments never leave their blocks; the
    step slices the full parameters and the reduced gradients down to its
    block and updates that; replicated leaves (BN, biases) update the same
    way on every rank.

The mesh's ``model`` axis is storage only: its ranks hold different blocks
but compute the same batch shard redundantly; gradients reduce over the
batch axes alone, the parameter gather runs over every axis a spec names.

Overlap with the backward itself (reducing bucket k while earlier layers'
gradients are still computed) would need per-leaf autograd hooks; the
port's pulls return every gradient at once, so the reductions overlap each
other and the host's flattening, not the backward.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..tree import flat_leaves, unflatten
from . import compression
from . import sharding as SH

__all__ = ["DEFAULT_BUCKET_BYTES", "BucketPlan", "plan_buckets", "reduce_bucketed", "CommState", "comm_specs",
           "init_comm_state", "wire_report", "param_structs", "build_gan_comm_step", "build_gan_mesh_step"]

log = logging.getLogger("repro_torch.parallel")

# 4 MiB of fp32 a bucket: large enough that the per-collective launch cost
# amortizes, small enough that the first reduction starts early
DEFAULT_BUCKET_BYTES = 4 << 20


# ------------------------------------------------------------------ buckets
@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static partition of a tree's leaves into reduction buckets.

    ``buckets[k]`` holds the flat-leaf indices (JAX's flattening order:
    dict keys sorted) of bucket k; every leaf index appears in exactly one
    bucket.  Buckets fill in reverse flatten order."""

    buckets: tuple[tuple[int, ...], ...]
    numels: tuple[int, ...]  # each bucket's element count
    n_leaves: int

    def covers_exactly_once(self) -> bool:
        seen = [i for b in self.buckets for i in b]
        return sorted(seen) == list(range(self.n_leaves))


def _numel(x) -> int:
    return int(np.prod(x.shape)) if len(x.shape) else 1


def plan_buckets(tree, *, bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> BucketPlan:
    """Greedy size-targeted bucketing of ``tree``'s leaves (tensors, numpy
    arrays, anything with a ``shape``).  A bucket closes once it holds at
    least ``bucket_bytes`` of fp32 payload; an oversized leaf gets its own."""
    leaves = flat_leaves(tree)
    buckets: list[tuple[int, ...]] = []
    numels: list[int] = []
    cur: list[int] = []
    cur_elems = 0
    for i in reversed(range(len(leaves))):  # backward-completion order
        cur.append(i)
        cur_elems += _numel(leaves[i])
        if cur_elems * 4 >= bucket_bytes:
            buckets.append(tuple(cur))
            numels.append(cur_elems)
            cur, cur_elems = [], 0
    if cur:
        buckets.append(tuple(cur))
        numels.append(cur_elems)
    return BucketPlan(tuple(buckets), tuple(numels), len(leaves))


def _flatten_bucket(leaves: list, idxs: tuple[int, ...]) -> torch.Tensor:
    return torch.cat([leaves[i].float().reshape(-1) for i in idxs])


def _unflatten_bucket(vec: torch.Tensor, leaves: list, out: list, idxs: tuple[int, ...]) -> None:
    """Scatter ``vec`` into ``out`` with each leaf's shape and dtype."""
    off = 0
    for i in idxs:
        n = leaves[i].numel()
        out[i] = vec[off:off + n].reshape(leaves[i].shape).to(leaves[i].dtype)
        off += n


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reduce_bucketed(grads, plan: BucketPlan, group, *, grad_compression: Optional[str] = None,
                    residuals: Optional[tuple] = None, axis_size: Optional[int] = None,
                    timings: Optional[list] = None):
    """Mean-reduce ``grads`` over the process group ``group`` with one
    collective per bucket, in plan order.  Uncompressed, every bucket's
    ``all_reduce`` is issued with ``async_op=True`` and the results are
    waited for after the last; ``grad_compression="int8"`` routes each
    bucket through ``compression.compressed_psum`` with ``residuals`` the
    per-bucket local error rows ((1, numel) each).  With ``timings`` (a
    list) each bucket runs on its own, bracketed by device synchronizes, and
    its wall ms is appended: a measurement, not the overlapped schedule.

    Returns (mean_grads, new_residuals); new_residuals is None without
    compression."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression: {grad_compression!r}")
    n = axis_size if axis_size is not None else dist.get_world_size(group)
    leaves = flat_leaves(grads)
    out = list(leaves)
    new_res: list = []
    pending = []
    for k, idxs in enumerate(plan.buckets):
        vec = _flatten_bucket(leaves, idxs)
        if timings is not None:
            _sync(vec.device)
            t0 = time.perf_counter()
        if grad_compression == "int8":
            red, nr = compression.compressed_psum(vec, residuals[k][0], group, axis_size=n)
            new_res.append(nr[None])
            _unflatten_bucket(red, leaves, out, idxs)
        elif timings is not None:
            dist.all_reduce(vec, group=group)
            _unflatten_bucket(vec / n, leaves, out, idxs)
        else:
            pending.append((dist.all_reduce(vec, group=group, async_op=True), vec, idxs))
        if timings is not None:
            _sync(vec.device)
            timings.append(1e3 * (time.perf_counter() - t0))
    for work, vec, idxs in pending:
        work.wait()
        _unflatten_bucket(vec / n, leaves, out, idxs)
    return unflatten(grads, out), (tuple(new_res) if grad_compression == "int8" else None)


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_leaves(grads)))


# ------------------------------------------------------------- comm state
class CommState(NamedTuple):
    """One rank's error-feedback residuals: per bucket a (1, numel) row, its
    block of the reference's (R, numel) array split one row per data shard
    (R the batch axes' extent).  ``train_gan`` checkpoints it (gathered)."""

    g_res: tuple
    d_res: tuple


def _rows(mesh) -> int:
    axes = SH.MeshAxes.for_mesh(mesh).batch
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def comm_specs(g_plan: BucketPlan, d_plan: BucketPlan, mesh) -> CommState:
    """The residuals' specs: each (R, numel) array split by rows over the
    batch axes."""
    axes = SH.MeshAxes.for_mesh(mesh).batch
    return CommState(tuple(SH.P(axes, None) for _ in g_plan.numels), tuple(SH.P(axes, None) for _ in d_plan.numels))


def init_comm_state(gp, dp, mesh, *, bucket_bytes: int = DEFAULT_BUCKET_BYTES, device=None) -> CommState:
    """Zero residuals for ``grad_compression="int8"``: this rank's row of
    each bucket.  ``gp`` / ``dp`` give the full leaves' shapes (full trees,
    or the meta trees a step's ``meta`` holds); the plan depends on nothing
    else."""
    device = device if device is not None else mesh.device
    g_plan = plan_buckets(gp, bucket_bytes=bucket_bytes)
    d_plan = plan_buckets(dp, bucket_bytes=bucket_bytes)
    mk = lambda plan: tuple(torch.zeros((1, n), dtype=torch.float32, device=device) for n in plan.numels)  # noqa: E731
    return CommState(mk(g_plan), mk(d_plan))


def wire_report(gp, dp, *, grad_compression: Optional[str] = None) -> dict:
    """Static per-step gradient-reduction wire accounting: elements and
    payload bytes at the leaves' own dtypes against the int8 format."""
    leaves = flat_leaves(gp) + flat_leaves(dp)
    elems = sum(_numel(g) for g in leaves)
    native = sum(_numel(g) * g.dtype.itemsize for g in leaves)
    return {
        "grad_elements": elems,
        "native_bytes_per_step": native,
        "int8_bytes_per_step": elems,
        "wire_bytes_per_step": elems if grad_compression == "int8" else native,
        "wire_bytes_saved": compression.wire_bytes_saved(leaves) if grad_compression == "int8" else 0,
    }


# ------------------------------------------------------------ the sharded steps
@functools.lru_cache(maxsize=None)
def param_structs(cfg, dtype):
    """Meta tensors with the shapes and dtypes of ``generator_init`` /
    ``discriminator_init``'s trees for ``cfg`` (the reference's
    ``eval_shape``)."""
    from ..models import gan as G
    from ..tree import tree_map

    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    gp = G.generator_init(cfg, seed=0, device="cpu", dtype=dtype)
    dp = G.discriminator_init(cfg, seed=1, device="cpu", dtype=dtype)
    return tree_map(meta, gp), tree_map(meta, dp)


def _check_rows(z, real, want: int) -> None:
    if z.shape[0] != want or real.shape[0] != want:
        raise ValueError(f"this rank's batch has {z.shape[0]} / {real.shape[0]} rows; its share of the global "
                         f"batch is {want} (take it with sharding.block_of and the step's batch specs)")


def _sharded_step(cfg, mesh, *, batch: int, lr: float, b1: float, g_plan, d_plan, grad_compression, dtype,
                  fallbacks: list, timings: Optional[dict] = None):
    """The shared body of the mesh steps (see the module docstring)."""
    from ..models import gan as G
    from ..models import layers as L
    from ..optim import adamw_update
    from ..train.resilience import nonfinite_flag
    from ..train.trainer import _grads, gan_losses
    from ..tree import tree_map

    axes = SH.MeshAxes.for_mesh(mesh).batch
    rows = _rows(mesh)
    group = mesh.group(axes) if axes else None
    gsp, dsp, _ = SH.gan_param_specs(cfg, mesh)
    zspec, rspec, _ = SH.gan_batch_specs(cfg, batch, mesh)
    replicated = zspec[0] is None and rows > 1  # the batch does not divide: every rank takes all of it
    local = batch if replicated or rows == 1 else batch // rows
    compress = grad_compression == "int8"

    def body(gp, dp, g_opt, d_opt, comm, z, real):
        _check_rows(z, real, local)
        gather = lambda tree, sp: SH.map_specs(lambda b, s: SH.gather(b, s, mesh), tree, sp)  # noqa: E731
        with torch.no_grad():
            gp_full, dp_full = gather(gp, gsp), gather(dp, dsp)
        gp_ = tree_map(lambda t: t.detach().requires_grad_(True), gp_full)
        dp_ = tree_map(lambda t: t.detach().requires_grad_(True), dp_full)
        with torch.enable_grad(), L.bn_sync_axis(None if replicated else group):
            g_loss, d_loss, (g_stats, d_stats, _) = gan_losses(gp_, dp_, cfg, z, real)
            g_grads = _grads(g_loss, gp_, retain_graph=True)
            d_grads = _grads(d_loss, dp_, retain_graph=False)
        detach = lambda tree: tree_map(torch.Tensor.detach, tree)  # noqa: E731
        g_stats, d_stats = detach(g_stats), detach(d_stats)
        if replicated or group is None:  # every rank took the whole batch: its gradients are the mean already
            d_red, g_red, d_res2, g_res2 = d_grads, g_grads, None, None
        else:
            t_d = [] if timings is not None else None
            t_g = [] if timings is not None else None
            d_red, d_res2 = reduce_bucketed(d_grads, d_plan, group, grad_compression=grad_compression,
                                            residuals=comm.d_res if compress else None, axis_size=rows, timings=t_d)
            g_red, g_res2 = reduce_bucketed(g_grads, g_plan, group, grad_compression=grad_compression,
                                            residuals=comm.g_res if compress else None, axis_size=rows, timings=t_g)
            if timings is not None:
                timings.setdefault("d", []).append(t_d)
                timings.setdefault("g", []).append(t_g)
        gn_g, gn_d = _global_norm(g_red), _global_norm(d_red)
        # ZeRO block updates: slice the full params and the reduced grads to
        # this rank's block; the moments are blocks already
        blk = lambda tree, sp: SH.map_specs(lambda t, s: SH.block_of(t, s, mesh), tree, sp)  # noqa: E731
        gp2, g_opt2, _ = adamw_update(blk(detach(gp_), gsp), blk(g_red, gsp), g_opt, lr=lr, b1=b1)
        dp2, d_opt2, _ = adamw_update(blk(detach(dp_), dsp), blk(d_red, dsp), d_opt, lr=lr, b1=b1)
        # BN running statistics are replicated leaves (synced batch stats):
        # merging into the block trees merges full leaves
        gp2, dp2 = G.merge_bn_stats(gp2, g_stats), G.merge_bn_stats(dp2, d_stats)
        losses = torch.stack([g_loss.detach(), d_loss.detach()]).float()
        if not (replicated or group is None):
            dist.all_reduce(losses, group=group)  # one collective for both losses
            losses = losses / rows
        metrics = {"g_loss": losses[0], "d_loss": losses[1], "g_grad_norm": gn_g, "d_grad_norm": gn_d}
        metrics["nonfinite"] = nonfinite_flag(metrics)
        comm2 = CommState(g_res2, d_res2) if compress else None
        return gp2, dp2, g_opt2, d_opt2, comm2, metrics

    gp_s, dp_s = param_structs(cfg, dtype)
    meta = {
        "fallbacks": list(fallbacks),
        "g_plan": g_plan,
        "d_plan": d_plan,
        "axes": axes,
        "specs": (gsp, dsp, SH.opt_specs(gsp), SH.opt_specs(dsp)),
        "batch_specs": (zspec, rspec),
        "param_structs": (gp_s, dp_s),
        "wire": wire_report(gp_s, dp_s, grad_compression=grad_compression),
        "comm_struct": CommState(tuple((rows, n) for n in g_plan.numels), tuple((rows, n) for n in d_plan.numels))
        if compress else None,
        "comm_specs": comm_specs(g_plan, d_plan, mesh) if compress else None,
    }
    if compress:
        step = body
    else:
        def step(gp, dp, g_opt, d_opt, z, real):
            o = body(gp, dp, g_opt, d_opt, None, z, real)
            return o[0], o[1], o[2], o[3], o[5]
    step.meta = meta
    return step, meta


def build_gan_comm_step(cfg, mesh, *, batch: int, lr: float = 2e-4, b1: float = 0.5,
                        grad_compression: Optional[str] = None, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                        donate: bool = True, dtype=torch.float32, timings: Optional[dict] = None):
    """The communication-efficient sharded GAN train step.  Returns
    ``(step_fn, meta)``.

    Without compression the step has ``make_gan_step``'s signature ``(gp,
    dp, g_opt, d_opt, z, real) -> (gp, dp, g_opt, d_opt, metrics)``; with
    ``grad_compression="int8"`` a ``CommState`` rides along: ``(gp, dp,
    g_opt, d_opt, comm, z, real) -> (gp, dp, g_opt, d_opt, comm,
    metrics)``.  ``gp``, ``dp`` and the optimizer states hold this rank's
    blocks (``sharding.block_of`` under ``meta["specs"]``); ``z`` and
    ``real`` its rows of the global batch (under ``meta["batch_specs"]``).
    Every rank of ``mesh`` calls the step together.  ``donate`` is accepted
    for the reference's signature: the port's step never reuses its inputs.
    ``timings`` (a dict) makes each bucket's reduction run on its own and
    records its ms under "d" and "g" per step (a measurement mode).

    ``meta`` carries the bucket plans, the sharding fallback log, the wire
    report and the comm state's shapes.  The batch must divide the batch
    axes' extent: this step refuses the replicated fallback the mesh step
    (``build_gan_mesh_step``) takes."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression: {grad_compression!r}")
    axes = SH.MeshAxes.for_mesh(mesh).batch
    if not axes:
        raise ValueError("mesh has no ('pod','data') axes — the overlapped step needs a data axis to reduce over")
    rows = _rows(mesh)
    if rows > 1 and batch % rows != 0:
        raise ValueError(f"batch {batch} must divide the data axes (extent {rows}) for the overlapped step — it "
                         "refuses the silent-replication fallback the GSPMD path allows")
    _, _, fallbacks = SH.gan_param_specs(cfg, mesh)
    _, _, bfb = SH.gan_batch_specs(cfg, batch, mesh)
    gp_s, dp_s = param_structs(cfg, dtype)
    return _sharded_step(cfg, mesh, batch=batch, lr=lr, b1=b1,
                         g_plan=plan_buckets(gp_s, bucket_bytes=bucket_bytes),
                         d_plan=plan_buckets(dp_s, bucket_bytes=bucket_bytes),
                         grad_compression=grad_compression, dtype=dtype, fallbacks=fallbacks + bfb, timings=timings)


def build_gan_mesh_step(cfg, mesh, *, batch: int, lr: float = 2e-4, b1: float = 0.5, dtype=torch.float32):
    """The counterpart of the reference's GSPMD step (``make_gan_step(mesh=
    ...)``): the same explicit-collective body with every gradient leaf
    reduced on its own, as the partitioner leaves them.  Where ``batch``
    does not divide the batch axes' extent it does what GSPMD does: both
    inputs replicate (every rank takes the whole batch, BN is not synced,
    nothing needs reducing), and the fallback goes to the log.  Returns
    ``(step_fn, meta)``."""
    _, _, fallbacks = SH.gan_param_specs(cfg, mesh)
    _, _, bfb = SH.gan_batch_specs(cfg, batch, mesh)
    for line in bfb:
        log.warning("sharding fallback: %s", line)
    gp_s, dp_s = param_structs(cfg, dtype)
    return _sharded_step(cfg, mesh, batch=batch, lr=lr, b1=b1, g_plan=plan_buckets(gp_s, bucket_bytes=1),
                         d_plan=plan_buckets(dp_s, bucket_bytes=1), grad_compression=None, dtype=dtype,
                         fallbacks=fallbacks + bfb)
