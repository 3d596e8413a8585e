"""Ranks for the port's distributed tests: ``spawn_ranks`` starts a world
of gloo processes on the CPU, each joined through a ``FileStore`` in the
test's own directory (never a fixed port: the test files run in parallel),
runs one of the workers below in every rank, and ``collect`` returns their
results.
Every spawn has a deadline, so a collective-order mismatch fails the test
instead of hanging it.

The workers import torch and the port only (a spawned rank does not import
the test module, nor JAX); they take and return numpy arrays.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np

DEADLINE_S = 150.0


def _entry(fn, rank, world, store_path, out_path, args, kwargs, pg_timeout=None):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        timeout = {} if pg_timeout is None else {"timeout": datetime.timedelta(seconds=pg_timeout)}
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
                                **timeout)
        res = (True, fn(rank, world, *args, **kwargs))
    except BaseException:  # noqa: BLE001 - the parent reports it
        res = (False, traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    if res[0]:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, tmp_path, *args, pg_timeout=None, **kwargs):
    """Start ``fn(rank, world, *args, **kwargs)`` on ``world`` gloo ranks;
    ``collect`` waits for them.  Several worlds may run at once.
    ``pg_timeout``: the process group's timeout in seconds (None: gloo's
    default)."""
    ctx = mp.get_context("spawn")
    root = os.path.join(str(tmp_path), f"{fn.__name__}_{world}_{time.monotonic_ns()}")
    os.makedirs(root)
    outs = [os.path.join(root, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_entry, args=(fn, r, world, os.path.join(root, "store"), outs[r], args, kwargs,
                                              pg_timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def collect(handle, deadline: float = DEADLINE_S) -> list:
    """The results of ``spawn_ranks``'s ranks, by rank.  Fails with every
    failed rank's traceback, or when the ranks are not done within
    ``deadline`` seconds of this call."""
    procs, outs = handle
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    results, errors = [], []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            ok, res = pickle.load(f)
        (results if ok else errors).append(res if ok else f"rank {r}:\n{res}")
    if hung:
        errors.insert(0, f"ranks {hung} still running after the {deadline:.0f} s deadline (a collective hangs)")
    assert not errors, "\n".join(errors)
    return results


# ------------------------------------------------------------------ helpers
class OneRankMesh:
    """A ("data",) mesh of one rank on the CPU, standing in for
    ``launch.make_mesh`` in a process without a process group: every
    block is the whole leaf, and nothing is gathered."""

    shape = {"data": 1}
    axis_names = ("data",)
    device = None

    def __init__(self):
        import torch

        self.device = torch.device("cpu")

    def index(self, axes) -> int:
        return 0


def _mesh(shape, axes):
    from repro_torch.launch import make_mesh

    return make_mesh(shape, axes, device="cpu")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _cfg(zoo_args):
    from repro_torch.configs import gan_zoo

    return gan_zoo.tiny_dcgan(*zoo_args)


def _params(cfg, gp_np, dp_np):
    from repro_torch.convert import discriminator_params_from_numpy, generator_params_from_numpy

    return generator_params_from_numpy(gp_np, cfg, device="cpu"), discriminator_params_from_numpy(dp_np, cfg,
                                                                                                    device="cpu")


# ------------------------------------------------------------------ workers
def sharded_runs(rank, world, shape, axes, zoo_args, gp_np, dp_np, runs, lr=2e-4):
    """For each (name, variant, bucket_bytes, batches) of ``runs``: a step
    a batch of a sharded step from the numpy params, ``variant`` "mesh"
    (make_gan_step(mesh=)), "overlap" (build_gan_comm_step at
    ``bucket_bytes``, None: the default) or "int8" (the same, compressed).
    Returns, by name: the metrics, the full params after the last step, the
    step-1 reduced gradients (AdamW's first moment over 1 - b1), the bucket
    plans, the fallback log and the residuals' largest magnitude."""
    import torch

    from repro_torch.optim import adamw_init
    from repro_torch.parallel import overlap as OV
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import StepSettings, make_gan_step

    mesh = _mesh(shape, axes)
    cfg = _cfg(zoo_args)
    blk = lambda tree, sp: SH.map_specs(lambda t, s: SH.block_of(t, s, mesh), tree, sp)  # noqa: E731
    full = lambda tree, sp: SH.map_specs(lambda t, s: SH.gather(t, s, mesh), tree, sp)  # noqa: E731
    out = {}
    for name, variant, bucket_bytes, batches in runs:
        B = batches[0][0].shape[0]
        kw = {} if bucket_bytes is None else {"bucket_bytes": bucket_bytes}
        if variant == "mesh":
            step = make_gan_step(cfg, settings=StepSettings(lr=lr, b1=0.5, mesh=mesh, batch=B))
        else:
            step, _ = OV.build_gan_comm_step(cfg, mesh, batch=B, lr=lr, b1=0.5,
                                             grad_compression="int8" if variant == "int8" else None, **kw)
        meta = step.meta
        gsp, dsp, _, _ = meta["specs"]
        zspec, rspec = meta["batch_specs"]
        gp, dp = _params(cfg, gp_np, dp_np)
        gp, dp = blk(gp, gsp), blk(dp, dsp)
        g_opt, d_opt = adamw_init(gp), adamw_init(dp)
        comm = OV.init_comm_state(*meta["param_structs"], mesh, **kw) if variant == "int8" else None
        metrics, first = [], None
        for z_np, real_np in batches:
            z = SH.block_of(torch.from_numpy(z_np), zspec, mesh)
            real = SH.block_of(torch.from_numpy(real_np), rspec, mesh)
            if comm is not None:
                gp, dp, g_opt, d_opt, comm, m = step(gp, dp, g_opt, d_opt, comm, z, real)
            else:
                gp, dp, g_opt, d_opt, m = step(gp, dp, g_opt, d_opt, z, real)
            metrics.append({k: float(v) for k, v in m.items()})
            if first is None:
                first = tuple({k: {kk: v / 0.5 for kk, v in leaf.items()} for k, leaf in _np(full(o.m, sp)).items()}
                              for o, sp in ((g_opt, gsp), (d_opt, dsp)))
        out[name] = dict(metrics=metrics, gp=_np(full(gp, gsp)), dp=_np(full(dp, dsp)), first=first,
                         g_plan=meta["g_plan"], d_plan=meta["d_plan"], fallbacks=meta["fallbacks"],
                         residual_max=None if comm is None else max(float(r.abs().max()) for r in comm.g_res),
                         blocks={k: tuple(v.shape) for k, v in gp["deconv0"].items()})
    return out


def compression_runs(rank, world, g_one, g_loop, T):
    """compressed_psum over every rank, each rank holding its row of the
    global arrays: one call on ``g_one`` (a tree of two leaves) from zero
    residuals -> (outputs, new residuals); then ``T`` calls on ``g_loop``
    with the residual threaded through -> the outputs' running sum and the
    first call's output."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.compression import compressed_psum, init_residuals

    grads = {k: torch.from_numpy(v[rank]) for k, v in g_one.items()}
    out, new_r = compressed_psum(grads, init_residuals(grads), dist.group.WORLD, axis_size=world)
    g = torch.from_numpy(g_loop[rank])
    res, acc, first = torch.zeros_like(g), torch.zeros_like(g), None
    for _ in range(T):
        o, res = compressed_psum(g, res, dist.group.WORLD)
        acc += o
        first = o.clone() if first is None else first
    return dict(out={k: v.numpy() for k, v in out.items()}, res={k: v.numpy() for k, v in new_r.items()},
                acc=acc.numpy(), first=first.numpy())


def elastic_save(rank, world, shape, axes, directory, x_np, spec):
    """Save ``x_np`` from its blocks under ``spec`` on the mesh (rank 0
    writes the gathered leaf); returns this rank's block."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import sharding as SH
    from repro_torch.train import checkpoint as C

    mesh = _mesh(shape, axes)
    spec = SH.P(*spec)
    block = SH.block_of(torch.from_numpy(x_np), spec, mesh)
    tree = {"w": SH.gather(block, spec, mesh), "opt": {"m": SH.gather(block * 2, spec, mesh)}}
    if rank == 0:
        C.save_checkpoint(directory, 3, tree)
    dist.barrier()
    return block.numpy()


def elastic_restore(rank, world, shape, axes, directory, full_shape, spec):
    """Restore step 3 onto the mesh under ``spec``: this rank's blocks and
    their gather."""
    import torch

    from repro_torch.parallel import sharding as SH
    from repro_torch.train import checkpoint as C

    mesh = _mesh(shape, axes)
    spec = SH.P(*spec)
    like = {"w": torch.empty(full_shape, device="meta"), "opt": {"m": torch.empty(full_shape, device="meta")}}
    sh = SH.named(mesh, {"w": spec, "opt": {"m": spec}})
    back = C.restore_checkpoint(directory, 3, like, device="cpu", shardings=sh)
    step, latest = C.restore_latest_valid(directory, like, device="cpu", shardings=sh)
    assert step == 3 and all(torch.equal(a, b) for a, b in ((back["w"], latest["w"]),
                                                            (back["opt"]["m"], latest["opt"]["m"])))
    return back["w"].numpy(), SH.gather(back["w"], spec, mesh).numpy(), SH.gather(back["opt"]["m"], spec, mesh).numpy()


def train_gan_runs(rank, world, shape, axes, zoo_args, batches_by_step, runs, **kw):
    """For each (name, directory, fault_step, grad_compression) of ``runs``:
    ``train_gan`` on the mesh with ``kw``, checkpointing into ``directory``
    (resuming what it holds), the batches JAX's for each step, an injected
    raise at ``fault_step`` (None: a clean run).  Returns by name the
    result's metrics, counters, fault log, final step and full params."""
    import torch

    from repro_torch import data as TD
    from repro_torch.train import StepSettings, TrainFaultPlan
    from repro_torch.train import trainer as TT

    mesh = _mesh(shape, axes)
    cfg = _cfg(zoo_args)
    TD.latent_batch = lambda seed, step, batch, z_dim, *, device="cuda": torch.from_numpy(
        batches_by_step[step][0]).to(device)
    TD.gan_batch = lambda seed, step, batch, hw, ch=3, *, device="cuda": torch.from_numpy(
        batches_by_step[step][1]).to(device)
    out = {}
    for name, directory, fault_step, gc in runs:
        plan = None if fault_step is None else TrainFaultPlan(kind="raise", at_step=fault_step, max_faults=1)
        res = TT.train_gan(cfg, ckpt_dir=directory, fault_plan=plan, device="cpu",
                           settings=StepSettings(lr=kw["lr"], b1=0.5, mesh=mesh, grad_compression=gc),
                           **{k: v for k, v in kw.items() if k != "lr"})
        out[name] = dict(metrics=res["metrics"], counters=res["counters"], fault_log=res["fault_log"],
                         final_step=res["final_step"], gp=_np(res["params"]["gp"]), dp=_np(res["params"]["dp"]))
    return out


def mesh_checks(rank, world, shape, axes, x_np, specs):
    """On one mesh: this rank's coordinates, the ranks in each axis's group
    (an all_gather of rank ids), its block of ``x_np`` under each spec and
    the gather of it, a mesh the world does not hold (its error), and NCCL
    with every rank on one card (its error; the backend and the ranks'
    device identities stood in for)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_mesh
    from repro_torch.parallel import sharding as SH

    mesh = _mesh(shape, axes)
    groups = {}
    for a in axes:
        ids = [torch.zeros(1, dtype=torch.int64) for _ in range(mesh.shape[a])]
        dist.all_gather(ids, torch.tensor([rank]), group=mesh.group(a))
        groups[a] = [int(t) for t in ids]
    x = torch.from_numpy(x_np)
    blocks = {str(sp): SH.block_of(x, SH.P(*sp), mesh).numpy() for sp in specs}
    back = {str(sp): SH.gather(torch.from_numpy(blocks[str(sp)]), SH.P(*sp), mesh).numpy() for sp in specs}
    try:
        make_mesh((world + 1,), ("data",), device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    # NCCL with ranks that share a card: every rank reports the same device
    from repro_torch.launch import mesh as M

    real = (M.dist.get_backend, M._device_identity)
    M.dist.get_backend, M._device_identity = (lambda *a: "nccl"), (lambda device: ("host", "card0"))
    try:
        make_mesh(shape, axes, device="cpu")
        shared = None
    except ValueError as e:
        shared = str(e)
    finally:
        M.dist.get_backend, M._device_identity = real
    return dict(coords=mesh.coords, groups=groups, blocks=blocks, back=back, refused=refused, shared=shared,
                extent=mesh.extent(axes), index=mesh.index(axes))


def autotune_runs(rank, world, shape, axes):
    """autotune_deconv(mode="step") on the mesh for a prepacked config and
    the plain path, then the same with grad_compression="int8"; the rows
    without their configs."""
    from repro_torch.core.tdc import DeconvDims
    from repro_torch.kernels import autotune as A

    mesh = _mesh(shape, axes)
    out = {}
    for gc in (None, "int8"):
        rows = A.autotune_deconv(DeconvDims(4, 2, 1, 0), (8, 4, 4, 16), 16,
                                 candidates=[A.EngineConfig(False, prepack=True), None], mode="step", repeats=1,
                                 device="cpu", mesh=mesh, grad_compression=gc)
        out[gc] = [{k: v for k, v in r.items() if k != "config"} for r in rows]
    return out


def serve_mesh_runs(rank, world, shape, axes, zoo_args, gp_np, dp_np, z_np):
    """Sharded residency on the mesh: this rank's blocks of the packed
    generator and discriminator (``prepack_generator`` /
    ``prepack_discriminator(mesh=)``) and whether they are ``block_of`` of
    the unsharded packed trees and gather back to them; the images of a
    ``GanServeEngine(mesh=)`` generate and of an engine serving a registry
    entry registered on the mesh; the resident's bytes at rest against the
    whole tree's."""
    import torch

    from repro_torch.models import gan as G
    from repro_torch.parallel import sharding as SH
    from repro_torch.serve import GanServeEngine
    from repro_torch.tree import tree_leaves

    mesh = _mesh(shape, axes)
    cfg = _cfg(zoo_args)
    gp, dp = _params(cfg, gp_np, dp_np)
    gblk, dblk = G.prepack_generator(gp, cfg, mesh=mesh), G.prepack_discriminator(dp, cfg, mesh=mesh)
    gfull, dfull = G.prepack_generator(gp, cfg), G.prepack_discriminator(dp, cfg)
    gsp, dsp = G.packed_generator_specs(cfg, mesh), SH.gan_param_specs(cfg, mesh)[1]
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))  # noqa: E731
    blocks_ok = same(gblk, G.place_params(gfull, gsp, mesh)) and same(dblk, G.place_params(dfull, dsp, mesh))
    gathered_ok = same(G.gather_params(gblk, gsp, mesh), gfull) and same(G.gather_params(dblk, dsp, mesh), dfull)
    z = torch.from_numpy(z_np)
    eng = GanServeEngine(gp, cfg, mesh=mesh, batch=4)
    img = eng.generate(z)
    G.register_prepacked_generator("dcgan", gp, cfg, mesh=mesh)
    eng2 = GanServeEngine(models={"dcgan": "dcgan"}, mesh=mesh, batch=4)
    img2 = eng2.submit(z, arch="dcgan").result()
    res = eng.archs[next(iter(eng.archs))]
    return dict(gblk=_np(gblk), dblk=_np(dblk), blocks_ok=blocks_ok, gathered_ok=gathered_ok, img=img.numpy(),
                img_registry=img2.numpy(), resident_bytes=res.resident_bytes(),
                full_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(gfull)),
                healthy=res.health_ok(), fallbacks=SH.gan_param_specs(cfg, mesh)[2])


def serve_mesh_fault(rank, world, shape, axes, zoo_args, gp_np, dp_np, z_np, bad_rank, linger_s=0.0):
    """A sharded generate in which rank ``bad_rank`` raises before its
    gather: every rank's request through the engine (no retries), how it
    ended and after how many seconds.  The bad rank then stays alive
    ``linger_s`` seconds before it returns (a process that keeps running:
    its peers see no closed connection)."""
    import torch

    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine

    mesh = _mesh(shape, axes)
    cfg = _cfg(zoo_args)
    gp, _ = _params(cfg, gp_np, dp_np)
    eng = GanServeEngine(gp, cfg, mesh=mesh, batch=4, max_retries=0)
    if rank == bad_rank:
        def broken(*a, **k):
            raise RuntimeError(f"injected fault on rank {rank}")

        G.gather_params = broken
    t0 = time.monotonic()
    try:
        eng.submit(torch.from_numpy(z_np)).result(timeout=60)
        outcome = "served"
    except Exception as e:  # noqa: BLE001 - the outcome is the result
        outcome = f"{type(e).__name__}: {e}"
    seconds = time.monotonic() - t0
    if rank == bad_rank:
        time.sleep(linger_s)
    return dict(outcome=outcome, seconds=seconds)


# ------------------------------------------------------------ the LM on a mesh
def _lm_cfg(arch, capacity_factor=None, moe_ep=False):
    import dataclasses

    from repro_torch.configs import smoke_config

    cfg = smoke_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    return dataclasses.replace(cfg, moe_ep=moe_ep)


def _t(x):
    import torch

    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x)


def _np_state(x):
    if isinstance(x, dict):
        return {k: _np_state(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x).__name__, {f: _np_state(v) for f, v in zip(x._fields, x)}
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def lm_train_runs(rank, world, shape, axes, runs):
    """For each (name, arch, capacity_factor, global_batch, params_np,
    batches_np) of ``runs``: ``build_lm_step`` train at ``smoke_config``
    (``capacity_factor`` None: the config's), the numpy params as this
    rank's blocks, a step a batch (this rank's rows).  Returns by name each
    step's loss, gradient norm, this rank's dropped MoE assignments, and
    the gathered params and AdamW moments after it, plus the fallback log."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.models import moe as MoE
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding as SH

    mesh = _mesh(shape, axes)
    out = {}
    for name, arch, cf, gb, params_np, batches in runs:
        cfg = _lm_cfg(arch, cf)
        T = next(iter(batches[0].values())).shape[1]
        readings = []
        step, _, meta = build_lm_step(cfg, ShapeConfig("train_test", T, gb, "train"), mesh, readings=readings)
        pspecs = SH.lm_param_specs(cfg, mesh)[0]
        bspecs = SH.lm_batch_specs(cfg, ShapeConfig("train_test", T, gb, "train"), mesh)
        params = SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), lm_params_from_numpy(params_np, cfg, "cpu"),
                              pspecs)
        opt = adamw_init(params)
        steps = []
        for b in batches:
            rows = {k: SH.block_of(_t(v), bspecs[k], mesh) for k, v in b.items()}
            with MoE.record_drops() as drops:
                params, opt, loss = step(params, opt, rows)
            full = lambda tree: SH.map_specs(lambda t, sp: SH.gather(t, sp, mesh), tree, pspecs)  # noqa: E731
            steps.append(dict(loss=float(loss), grad_norm=readings[-1]["grad_norm"], rows=rows[next(iter(rows))].shape[0],
                              drops=int(sum(int(d) for d in drops)), params=_np(full(params)), m=_np(full(opt.m)),
                              v=_np(full(opt.v)), opt_step=opt.step))
        out[name] = dict(steps=steps, fallbacks=meta["fallbacks"])
    return out


def lm_prefill_runs(rank, world, shape, axes, runs):
    """For each (name, arch, capacity_factor, params_np, batch_np) of
    ``runs``: ``build_lm_step`` prefill at ``smoke_config`` on this rank's rows (the
    cell's seq_len the batch's T, its global batch the batch's rows).
    Returns by name this rank's logits and cache block (numpy), and its mesh
    coordinates."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.parallel import sharding as SH

    mesh = _mesh(shape, axes)
    out = {}
    for name, arch, cf, params_np, batch in runs:
        cfg = _lm_cfg(arch, cf)
        B, T = next(iter(batch.values())).shape[:2]
        cell = ShapeConfig("prefill_test", T, B, "prefill")
        fn, _, _ = build_lm_step(cfg, cell, mesh)
        pspecs = SH.lm_param_specs(cfg, mesh)[0]
        params = SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), lm_params_from_numpy(params_np, cfg, "cpu"),
                              pspecs)
        bspecs = SH.lm_batch_specs(cfg, cell, mesh)
        logits, cache = fn(params, {k: SH.block_of(_t(v), bspecs[k], mesh) for k, v in batch.items()})
        out[name] = dict(logits=logits.numpy(), cache=_np_state(cache))
    return dict(out, coords=mesh.coords)


def moe_drop_runs(rank, world, shape, axes, arch, capacity_factor, moe_np, x_np):
    """The MoE of ``arch``'s smoke config at ``capacity_factor`` on this
    rank's rows of ``x_np``: the global-capacity ``moe_apply(mesh=)`` (out,
    aux share, dropped assignments) and the per-rank-capacity plain call
    (out), which is what the expert-parallel form computes."""
    import torch

    from repro_torch.models import moe as MoE
    from repro_torch.parallel import sharding as SH

    mesh = _mesh(shape, axes)
    cfg = _lm_cfg(arch, capacity_factor)
    p = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in moe_np.items()}
    x = SH.block_of(torch.from_numpy(x_np), SH.P(SH.MeshAxes.for_mesh(mesh).batch, None, None), mesh)
    with MoE.record_drops() as drops:
        out, aux = MoE.moe_apply(p, x, cfg.moe, cfg.mlp, mesh=mesh)
    plain, _ = MoE.moe_apply(p, x, cfg.moe, cfg.mlp)
    return dict(out=out.numpy(), aux=float(aux), drops=int(drops[0]), plain=plain.numpy())


def lm_mesh_runs(rank, world, shape, axes, train, prefill, drop=None):
    """One world's LM mesh work: ``lm_train_runs`` on ``train``,
    ``lm_prefill_runs`` on ``prefill`` and, given ``drop`` (the arguments
    after ``axes`` of ``moe_drop_runs``), the MoE drop case."""
    out = dict(train=lm_train_runs(rank, world, shape, axes, train),
               prefill=lm_prefill_runs(rank, world, shape, axes, prefill))
    if drop is not None:
        out["drop"] = moe_drop_runs(rank, world, shape, axes, *drop)
    return out


def seq_attention_runs(rank, world, q, k, v, cache_len, kv_positions):
    """``seq_sharded_decode_attention`` on a (world, 1) ("data", "model")
    mesh, this rank holding its slice of the sequence of ``k`` / ``v`` (and
    of ``kv_positions``): the output without and with the positions."""
    import torch

    from repro_torch.models.attention import seq_sharded_decode_attention
    from repro_torch.parallel import sharding as SH

    mesh = _mesh((world, 1), ("data", "model"))
    sl = lambda x: SH.block_of(torch.from_numpy(x), SH.P(None, "data", *(None,) * (x.ndim - 2)), mesh)  # noqa: E731
    q, k_l, v_l = torch.from_numpy(q), sl(k), sl(v)
    plain = seq_sharded_decode_attention(q, k_l, v_l, cache_len, mesh=mesh)
    placed = seq_sharded_decode_attention(q, k_l, v_l, cache_len, mesh=mesh, kv_positions=sl(kv_positions))
    return dict(plain=plain.numpy(), placed=placed.numpy())


def _cache_from_np(cache_np):
    import torch

    from repro_torch.models.lm import AttnCache
    from repro_torch.models.ssm import SSMCache

    kinds = {"AttnCache": AttnCache, "SSMCache": SSMCache}
    return {k: kinds[kind](**{f: torch.from_numpy(np.array(v)) for f, v in fields.items()})
            for k, (kind, fields) in cache_np.items()}


def lm_decode_runs(rank, world, shape, axes, runs):
    """For each (name, arch, params_np, cache_np, tokens, cache_len,
    seq_shard) of ``runs``, at ``smoke_config``: with ``seq_shard``
    ``decode_step(seq_shard_axis="data")`` on this rank's block of the
    cache under ``cache_specs(seq_shard=True)`` (the batch replicated),
    else ``build_lm_step``'s decode cell (the batch split) on this rank's
    rows and cache block.  Returns by name the logits and the new cache
    block (numpy)."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.models import lm as LM
    from repro_torch.parallel import sharding as SH

    mesh = _mesh(shape, axes)
    out = {}
    for name, arch, params_np, cache_np, tokens, cache_len, seq_shard in runs:
        cfg = _lm_cfg(arch)
        B = tokens.shape[0]
        cache = _cache_from_np(cache_np)
        S = next(c.k.shape[2] for c in cache.values() if hasattr(c, "k"))
        cell = ShapeConfig("decode_test", S, B, "decode")
        cache = SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), cache,
                             SH.cache_specs(cfg, cell, mesh, seq_shard=seq_shard))
        params = lm_params_from_numpy(params_np, cfg, "cpu")
        if seq_shard:
            with torch.no_grad():
                logits, new = LM.decode_step(params, cfg, cache, _t(tokens), cache_len, mesh=mesh,
                                             seq_shard_axis="data", global_batch=B)
        else:
            fn, _, _ = build_lm_step(cfg, cell, mesh)
            pspecs = SH.lm_param_specs(cfg, mesh)[0]
            rows = SH.block_of(_t(tokens), SH.P(SH.MeshAxes.for_mesh(mesh).batch, None), mesh)
            logits, new = fn(SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), params, pspecs), cache,
                             {"tokens": rows}, cache_len)
        out[name] = dict(logits=logits.numpy(), cache=_np_state(new))
    return dict(out, coords=mesh.coords)


def moe_ep_runs(rank, world, arch, capacity_factor, moe_np, x_np, ct_np):
    """``moe_apply_ep`` on a (world, 1) ("data", "model") mesh with this
    rank's rows of ``x_np``: the output, this rank's aux share, its dropped
    assignments, and the gradients of sum(out * ct) + aux share in its rows
    of x and in the full weights."""
    import torch

    from repro_torch.models import moe as MoE
    from repro_torch.parallel import sharding as SH

    mesh = _mesh((world, 1), ("data", "model"))
    cfg = _lm_cfg(arch, capacity_factor, moe_ep=True)
    p = {k: {kk: torch.from_numpy(vv).requires_grad_(True) for kk, vv in v.items()} for k, v in moe_np.items()}
    rows = SH.P(("data",), None, None)
    x = SH.block_of(torch.from_numpy(x_np), rows, mesh).requires_grad_(True)
    ct = SH.block_of(torch.from_numpy(ct_np), rows, mesh)
    with MoE.record_drops() as drops:
        out, aux = MoE.moe_apply_ep(p, x, cfg.moe, cfg.mlp, mesh=mesh)
    ((out * ct).sum() + aux).backward()
    return dict(out=out.detach().numpy(), aux=float(aux), drops=int(drops[0]), dx=x.grad.numpy(),
                dp={k: {kk: vv.grad.numpy() for kk, vv in v.items()} for k, v in p.items()})


def _structs(x):
    """A struct tree as (shape, dtype name) leaves; ints pass through."""
    if isinstance(x, dict):
        return {k: _structs(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_structs(v) for v in x)
    if hasattr(x, "shape"):
        assert x.device.type == "meta", x.device
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    return x


def launch_structs(rank, world, cells):
    """``launch.steps.build_step`` on a (1, 1) ("data", "model") mesh for
    each (arch, shape name) of ``cells``: the step's name, its arg structs
    as (shape, dtype) leaves, and whether the decode cache is
    sequence-sharded."""
    from repro_torch.launch.steps import build_step

    mesh = _mesh((1, 1), ("data", "model"))
    out = {}
    for arch, shape in cells:
        fn, args, meta = build_step(arch, shape, mesh)
        out[(arch, shape)] = dict(name=fn.__name__, args=_structs(args), seq_shard=meta.get("seq_shard"))
    return out


def gan_step_dispatch(rank, world, zoo_args, gp_np, dp_np, z_np, real_np):
    """``build_gan_step`` on a (world,) ("data",) mesh against the step it
    maps to (``build_gan_mesh_step`` by default, ``build_gan_comm_step``
    with ``overlap`` and with int8 compression): one step each from the same
    blocks; whether every output is bitwise the same, and the struct
    trees' lengths."""
    import torch

    from repro_torch.launch.steps import build_gan_step
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import overlap as OV
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import StepSettings
    from repro_torch.tree import tree_leaves

    mesh = _mesh((world,), ("data",))
    cfg = _cfg(zoo_args)
    B = z_np.shape[0]
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))  # noqa: E731
    out = {}
    for name, st, other in (("mesh", StepSettings(batch=B), lambda: OV.build_gan_mesh_step(cfg, mesh, batch=B)),
                            ("overlap", StepSettings(batch=B, overlap=True),
                             lambda: OV.build_gan_comm_step(cfg, mesh, batch=B)),
                            ("int8", StepSettings(batch=B, grad_compression="int8"),
                             lambda: OV.build_gan_comm_step(cfg, mesh, batch=B, grad_compression="int8"))):
        fn, args, meta = build_gan_step(cfg, mesh, settings=st)
        ref, _ = other()
        gsp, dsp, _, _ = meta["specs"]
        zspec, rspec = meta["batch_specs"]
        results = []
        for step in (fn, ref):
            gp, dp = _params(cfg, gp_np, dp_np)
            gp, dp = SH.map_specs(lambda t, s: SH.block_of(t, s, mesh), gp, gsp), \
                SH.map_specs(lambda t, s: SH.block_of(t, s, mesh), dp, dsp)
            state = [gp, dp, adamw_init(gp), adamw_init(dp)]
            if name == "int8":
                state.append(OV.init_comm_state(*meta["param_structs"], mesh))
            z, real = SH.block_of(torch.from_numpy(z_np), zspec, mesh), SH.block_of(torch.from_numpy(real_np), rspec,
                                                                                     mesh)
            o = step(*state, z, real)
            results.append([o[0], o[1], o[-1]])
        out[name] = dict(same=all(same(a, b) for a, b in zip(*results)), n_args=len(args),
                         comm=type(args[4]).__name__ if name == "int8" else None)
    return out
