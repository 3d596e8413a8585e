"""Training: the adversarial GAN train step, on one device or on a mesh,
and the resilient ``train_gan`` loop (the reference's ``train/trainer.py``).

The step: one shared forward of ``gan_losses`` gives both objectives; two
``torch.autograd.grad`` pulls on that one graph give the generator's
gradients (``retain_graph=True``) and then the discriminator's.  The D pull
asks only for the discriminator's leaves, so autograd never runs the
generator's backward for it.  Each side then takes an AdamW step and its
moved batchnorm statistics.

The loop's fault-tolerance contract (``train/resilience.py`` has the
pieces), as the reference's:
  * every ``ckpt_every`` steps the (params, optimizer state) tree and the
    loop state (metrics history, lr scale, counters) are checkpointed
    atomically and fsync-durably, in the reference's format: a run resumes
    from either package's checkpoint directory;
  * a step failure (a raised error, an injected fault, a straggler
    deadline) restores the newest valid checkpoint and replays (the data
    are a pure function of (seed, step), so replay is exact) under a
    bounded ``FaultPolicy``; a fault that re-fires at the same step
    escalates into a carried ``TrainFaultError``;
  * a step sentinel (the step's finiteness flag plus a host-side windowed
    divergence detector) catches NaN losses and blown-up trajectories the
    step they happen; the policy decides skip / rollback (with an lr-scale
    knob) / abort;
  * SIGTERM/SIGINT request a preemption-safe exit: one final atomic
    checkpoint, then a clean return with ``"preempted": True``; the resumed
    run is bit-exact against an uninterrupted one;
  * with the sentinel on (the default) the loop reads the step's five
    metric scalars each step in one device-to-host copy; with it off only
    at log boundaries, so the host keeps queueing steps ahead of the card.

On a mesh (``StepSettings.mesh``, a ``launch.mesh.Mesh``) every rank runs
the loop in lockstep: the steps are ``parallel.overlap``'s, the parameters
and moments live as each rank's blocks, every rank draws the global batch
from (seed, step) and takes its rows, and only rank 0 writes checkpoints
(gathered to full leaves, in the reference's format), behind a barrier.
A ``TrainFaultPlan`` fault, an injected raise and the sentinel see the
same step and the same all-reduced metrics on every rank, and a preemption
request on any rank is honoured by all at the next step boundary.  A fault
raised on one rank only (a rank-local error, a straggler deadline that one
rank misses) is not covered: the other ranks wait in their next
collective.  The single-controller reference never sees such a fault.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import warnings
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .. import data as D
from .. import tracing
from ..configs.base import GANConfig
from ..models import gan as G
from ..optim import adamw_init, adamw_update
from ..tree import tree_leaves, tree_map
from . import checkpoint as C
from . import resilience as R
from .resilience import nonfinite_flag

__all__ = ["METRIC_SPEC_KEYS", "TrainHooks", "StepSettings", "nonfinite_flag", "gan_losses", "make_gan_step",
           "train_gan"]

#: every step emits these
METRIC_SPEC_KEYS = ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm", "nonfinite")


@dataclasses.dataclass
class TrainHooks:
    """Injection points used by tests (fault injection) and launchers."""

    on_step: Optional[Callable[[int, dict], None]] = None
    inject_fault_at: Optional[int] = None  # raise once at this step (test hook)
    step_deadline_s: float = 0.0  # 0 = no watchdog


@dataclasses.dataclass(frozen=True)
class StepSettings:
    """How a GAN train step is built, in one bundle (the reference's fields).

    Fields:
      lr, b1            AdamW learning rate / beta1
      batch             the loop's global batch (the reference's divisibility
                        check on a mesh; no effect on one device)
      mesh              a ``launch.mesh.Mesh``: the sharded step
                        (``parallel.overlap.build_gan_mesh_step``), params
                        and moments as ZeRO blocks under
                        ``parallel.sharding.gan_param_specs``
      donate            accepted for the reference's call signatures, no
                        effect: the port's step never reuses its inputs'
                        storage, so the pre-step params a "skip" reverts to
                        stay alive either way
      overlap           the explicit-collective step of
                        ``parallel.overlap.build_gan_comm_step``: bucketed
                        gradient reduction, sync-BN, ZeRO block updates
      grad_compression  "int8" threads an error-feedback ``CommState``
                        through the step (implies the overlap step)
      bucket_bytes      the overlap step's bucket target
      deconv_impl       generator backend override (None = cfg's)
      conv_impl         discriminator backend override (None = cfg's)
    """

    lr: float = 2e-4
    b1: float = 0.5
    mesh: Any = None
    batch: Optional[int] = None
    donate: bool = True
    overlap: bool = False
    grad_compression: Optional[str] = None
    bucket_bytes: Optional[int] = None
    deconv_impl: Optional[str] = None
    conv_impl: Optional[str] = None

    @property
    def comm(self) -> bool:
        """True when the explicit-collective (overlap) step is selected."""
        return self.overlap or self.grad_compression is not None

    def apply_to_cfg(self, cfg: GANConfig) -> GANConfig:
        """cfg with the impl overrides substituted."""
        if self.deconv_impl is not None:
            cfg = dataclasses.replace(cfg, deconv_impl=self.deconv_impl)
        if self.conv_impl is not None:
            cfg = dataclasses.replace(cfg, conv_impl=self.conv_impl)
        return cfg


_UNSET = object()  # tells "legacy kwarg not passed" from None / False


def _merge_legacy(settings: Optional[StepSettings], legacy: dict, where: str) -> StepSettings:
    """Fold the legacy kwargs a caller passed over ``settings`` (or the
    defaults), with the reference's ``DeprecationWarning``."""
    given = {k: v for k, v in legacy.items() if v is not _UNSET}
    base = settings if settings is not None else StepSettings()
    if not given:
        return base
    warnings.warn(
        f"{where}: kwargs {sorted(given)} are deprecated; pass settings=StepSettings(...) instead",
        DeprecationWarning, stacklevel=3,
    )
    return dataclasses.replace(base, **given)


def _bce(logit: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.clamp_min(logit, 0) - logit * target + torch.log1p(torch.exp(-logit.abs())))


def gan_losses(gp, dp, cfg: GANConfig, z, real, *, training=True):
    """(g_loss, d_loss, (g_stats, d_stats, fake)): the non-saturating
    generator loss and the discriminator loss from one generator forward;
    the discriminator's moved statistics are those of the real pass."""
    with tracing.span("model.generator"):
        fake, g_stats = G.generator_apply(gp, cfg, z, training=training)
    with tracing.span("model.discriminator"):
        d_fake, _ = G.discriminator_apply(dp, cfg, fake, training=training)
    with tracing.span("model.discriminator"):
        d_real, d_stats = G.discriminator_apply(dp, cfg, real, training=training)
    g_loss = _bce(d_fake, 1.0)
    d_loss = 0.5 * (_bce(d_real, 1.0) + _bce(d_fake, 0.0))
    return g_loss, d_loss, (g_stats, d_stats, fake)


def _grads(loss, tree, *, retain_graph: bool):
    """d loss / d every leaf of ``tree``, as a tree; leaves the loss does
    not reach (running statistics) get zeros."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(loss, leaves, retain_graph=retain_graph, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs))
    return tree_map(lambda _: next(it), tree)


def make_gan_step(cfg: GANConfig, lr=_UNSET, b1=_UNSET, *, settings: Optional[StepSettings] = None, mesh=_UNSET,
                  batch=_UNSET, donate=_UNSET, overlap=_UNSET, grad_compression=_UNSET, bucket_bytes=_UNSET):
    """The GAN train step ``step(gp, dp, g_opt, d_opt, z, real) -> (gp, dp,
    g_opt, d_opt, metrics)``: a simultaneous G/D update from one shared
    forward and two gradient pulls.  Inputs are left as they are; the
    returned trees are new.  ``metrics`` holds 0-d tensors under
    ``METRIC_SPEC_KEYS``.  How the step is built comes from
    ``settings=StepSettings(...)``; ``lr``, ``b1`` and the multi-device
    kwargs are the reference's deprecated spelling of the same fields.

    With ``settings.mesh`` (and ``settings.batch``, the global batch, for
    the divisibility rules) the step is the sharded one every rank calls
    together: ``parallel.overlap.build_gan_mesh_step``, the counterpart of
    the reference's GSPMD step (each gradient leaf reduced on its own; a
    batch that does not divide the batch axes replicates, with the
    fallback logged).  ``settings.overlap`` or ``grad_compression`` select
    ``parallel.overlap.build_gan_comm_step`` instead (bucketed reduction,
    ``bucket_bytes``; with "int8" a ``CommState`` rides between the
    optimizer states and the batch).  On a mesh the trees hold this rank's
    blocks and ``z`` / ``real`` its rows (``step.meta`` has the specs)."""
    st = _merge_legacy(settings, dict(lr=lr, b1=b1, mesh=mesh, batch=batch, donate=donate, overlap=overlap,
                                      grad_compression=grad_compression, bucket_bytes=bucket_bytes),
                       "make_gan_step")
    cfg = st.apply_to_cfg(cfg)
    lr, b1 = st.lr, st.b1
    if st.comm or st.mesh is not None:
        if st.mesh is None or st.batch is None:
            raise ValueError("a mesh step needs mesh and batch (the global batch)"
                             if not st.comm else "overlap/grad_compression require mesh and batch")
        from ..parallel import overlap as OV

        if st.comm:
            kw = {} if st.bucket_bytes is None else {"bucket_bytes": st.bucket_bytes}
            return OV.build_gan_comm_step(cfg, st.mesh, batch=st.batch, lr=lr, b1=b1,
                                          grad_compression=st.grad_compression, donate=st.donate, **kw)[0]
        return OV.build_gan_mesh_step(cfg, st.mesh, batch=st.batch, lr=lr, b1=b1)[0]

    calls = itertools.count()

    def step(gp, dp, g_opt, d_opt, z, real):
        with tracing.scope("train.step", ("step", next(calls))):
            gp_ = tree_map(lambda t: t.detach().requires_grad_(True), gp)
            dp_ = tree_map(lambda t: t.detach().requires_grad_(True), dp)
            with torch.enable_grad():
                with tracing.span("train.forward"):
                    g_loss, d_loss, (g_stats, d_stats, _) = gan_losses(gp_, dp_, cfg, z, real)
                with tracing.span("train.g_pull"):
                    g_grads = _grads(g_loss, gp_, retain_graph=True)
                with tracing.span("train.d_pull"):
                    d_grads = _grads(d_loss, dp_, retain_graph=False)
            detach = lambda tree: tree_map(torch.Tensor.detach, tree)  # noqa: E731
            with tracing.span("train.adamw"):
                gp2, g_opt2, gm = adamw_update(detach(gp_), g_grads, g_opt, lr=lr, b1=b1)
                gp2 = G.merge_bn_stats(gp2, detach(g_stats))
                dp2, d_opt2, dm = adamw_update(detach(dp_), d_grads, d_opt, lr=lr, b1=b1)
                dp2 = G.merge_bn_stats(dp2, detach(d_stats))
            metrics = {
                "g_loss": g_loss.detach(),
                "d_loss": d_loss.detach(),
                "g_grad_norm": gm["grad_norm"],
                "d_grad_norm": dm["grad_norm"],
            }
            metrics["nonfinite"] = nonfinite_flag(metrics)
        return gp2, dp2, g_opt2, d_opt2, metrics

    return step


def _host_metrics(m: dict) -> dict:
    """The step's metric scalars as Python floats, in one device-to-host
    copy (a ``float()`` per key would wait on the device once per key)."""
    keys = list(m)
    return dict(zip(keys, torch.stack([m[k].float() for k in keys]).tolist()))


def train_gan(
    cfg: GANConfig,
    *,
    steps: int = 200,
    batch: int = 16,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    hooks: Optional[TrainHooks] = None,
    dtype=torch.float32,
    settings: Optional[StepSettings] = None,
    policy: Optional[R.FaultPolicy] = None,
    fault_plan=None,
    handle_signals: bool = True,
    device="cuda",
    deconv_impl=_UNSET,
    conv_impl=_UNSET,
    mesh=_UNSET,
    overlap=_UNSET,
    grad_compression=_UNSET,
    bucket_bytes=_UNSET,
) -> dict:
    """End-to-end GAN training on synthetic data, on ``device``; restartable.

    Step construction comes from ``settings=StepSettings(...)`` (the
    ``deconv_impl`` / ``conv_impl`` / ``mesh`` / ``overlap`` /
    ``grad_compression`` / ``bucket_bytes`` kwargs are the reference's
    deprecated spelling of the same fields).  With a ``*_prepacked`` or chained impl the
    params hold packed Winograd-domain weights and every step runs on the
    engine kernels (``cuda_chained`` on both nets is the reference's main
    training path, ``pallas_chained``).

    Init is ``generator_init(cfg, seed=seed)`` and
    ``discriminator_init(cfg, seed=seed + 1)`` on ``device``, a pure
    function of ``seed`` (a restart from init depends on it).  The port's
    random streams are PyTorch's, not ``jax.random``'s: from one seed the
    two packages start from different params and draw different batches.
    Parity with the reference goes through a checkpoint: both resume from
    one step-0 checkpoint (the tests feed both the same batches).

    Resilience (``train/resilience.py``): ``policy`` bounds fault restores
    and decides what a sentinel-flagged divergent step does;
    ``fault_plan`` installs one ``TrainFaultPlan`` or a sequence of them;
    with ``handle_signals`` SIGTERM/SIGINT trigger a final checkpoint and a
    return with ``"preempted": True``.  The result carries ``counters`` /
    ``fault_log`` / ``faults_injected`` for reconciling injected against
    handled faults.  The fault path catches ``RuntimeError`` and
    ``TimeoutError``, as the reference does (torch's CUDA errors are
    ``RuntimeError``s); a sticky CUDA error (an illegal address) leaves the
    context unusable, and no restore recovers from it.

    ``device="cuda"`` without a card raises: the port has no fallback.

    ``mesh`` runs the loop on every rank of a ``launch.mesh.Mesh`` in
    lockstep (see the module docstring): each rank calls ``train_gan`` with
    the same arguments and ``device`` of the mesh's device type; the result's
    ``params`` are the full trees, gathered.  With int8 compression the
    error-feedback residuals are part of the checkpoint tree, so a restore
    replays bit-exact; a checkpoint without them restores with zeroed
    residuals.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_gan(device='cuda') needs a CUDA device (device='cpu' runs the plain versions)")
    hooks = hooks if hooks is not None else TrainHooks()
    st = _merge_legacy(settings, dict(deconv_impl=deconv_impl, conv_impl=conv_impl, mesh=mesh, overlap=overlap,
                                      grad_compression=grad_compression, bucket_bytes=bucket_bytes), "train_gan")
    st = dataclasses.replace(st, batch=batch)  # the loop batch is the global batch
    cfg = st.apply_to_cfg(cfg)
    mesh = st.mesh
    if mesh is None and st.comm:
        raise ValueError("overlap/grad_compression require mesh")
    if mesh is not None:
        from ..parallel import overlap as OV
        from ..parallel import sharding as SH

        if torch.device(device).type != mesh.device.type:
            raise ValueError(f"train_gan(device={device!r}) on a mesh of {mesh.device} devices")
        device = mesh.device
        gsp, dsp, _ = SH.gan_param_specs(cfg, mesh)
        specs = {"gp": gsp, "dp": dsp, "g_opt": SH.opt_specs(gsp), "d_opt": SH.opt_specs(dsp)}
        zspec, rspec, _ = SH.gan_batch_specs(cfg, batch, mesh)
        ckw = {} if st.bucket_bytes is None else {"bucket_bytes": st.bucket_bytes}
    pol = policy if policy is not None else R.FaultPolicy()
    plans = () if fault_plan is None else (
        tuple(fault_plan) if isinstance(fault_plan, (list, tuple)) else (fault_plan,)
    )
    skip_mode = pol.on_divergence == "skip"
    detector = R.DivergenceDetector(pol) if pol.sentinel else None

    counters: dict = {
        "restores": 0, "rollbacks": 0, "skips": 0, "sentinel_trips": 0,
        "ckpt_fallbacks": 0, "injected_handled": {},
    }
    fault_log: list[dict] = []

    def _warn_corrupt(step_, err):
        counters["ckpt_fallbacks"] += 1
        warnings.warn(
            f"checkpoint step {step_} failed integrity verification ({err}); falling back to the next-older "
            "checkpoint", RuntimeWarning, stacklevel=2,
        )

    def _place(tree: dict) -> dict:
        """On a mesh, each rank's blocks of the full trees."""
        if mesh is None:
            return tree
        return {k: SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), v, specs[k]) for k, v in tree.items()}

    def _init():
        gp_ = G.generator_init(cfg, seed=seed, device=device, dtype=dtype)
        dp_ = G.discriminator_init(cfg, seed=seed + 1, device=device, dtype=dtype)
        t = _place({"gp": gp_, "dp": dp_})
        return t["gp"], t["dp"], adamw_init(t["gp"]), adamw_init(t["dp"])

    gp, dp, g_opt, d_opt = _init()
    comm = None
    if mesh is None:
        _like = lambda: {"gp": gp, "dp": dp, "g_opt": g_opt, "d_opt": d_opt}  # noqa: E731
        where = None
    else:
        # the checkpoint holds full leaves: restore against full-shape meta
        # templates, each rank keeping its blocks
        gp_s, dp_s = OV.param_structs(cfg, dtype)
        full = {"gp": gp_s, "dp": dp_s, "g_opt": adamw_init(gp_s), "d_opt": adamw_init(dp_s)}
        _like = lambda: full  # noqa: E731
        where = SH.named(mesh, specs)
        if st.grad_compression is not None:
            comm = OV.init_comm_state(gp_s, dp_s, mesh, **ckw)
            rows = mesh.extent(SH.MeshAxes.for_mesh(mesh).batch)  # the residuals' full arrays: a row a data shard
            comm_full = OV.CommState(*(tuple(torch.empty((rows, r.shape[1]), device="meta") for r in res)
                                       for res in comm))
            comm_where = SH.named(mesh, OV.comm_specs(OV.plan_buckets(gp_s, **ckw), OV.plan_buckets(dp_s, **ckw),
                                                     mesh))

    def _restore_comm(step_):
        """The residuals saved with ``step_``; zeros for a checkpoint
        without them (one step of bounded extra quantization error)."""
        try:
            return C.restore_checkpoint(ckpt_dir, step_, {"comm": comm_full}, device=device,
                                        shardings={"comm": comm_where})["comm"]
        except KeyError as e:
            if "checkpoint missing leaf" not in str(e):
                raise
            return OV.init_comm_state(gp_s, dp_s, mesh, **ckw)

    start = 0
    restored_ls = None
    if ckpt_dir:
        last, tree = C.restore_latest_valid(ckpt_dir, _like(), device=device, shardings=where, on_skip=_warn_corrupt)
        if last is not None:
            gp, dp, g_opt, d_opt = tree["gp"], tree["dp"], tree["g_opt"], tree["d_opt"]
            start = last
            restored_ls = C.load_loop_state(ckpt_dir, last)
            if comm is not None:
                comm = _restore_comm(last)

    def _build_step(scale: float):
        s2 = st if scale == 1.0 else dataclasses.replace(st, lr=st.lr * scale)
        if mesh is not None:
            return make_gan_step(cfg, settings=s2)
        return make_gan_step(cfg, settings=dataclasses.replace(s2, batch=None))

    def _any_rank(flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (one all-reduce on a mesh)."""
        if mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    step_fn = _build_step(1.0)
    metrics_hist: list[dict] = []
    lr_scale = 1.0
    if restored_ls:
        metrics_hist = [e for e in restored_ls.get("metrics_hist", []) if e.get("step", 0) <= start]
        lr_scale = float(restored_ls.get("lr_scale", 1.0))
        if lr_scale != 1.0:
            step_fn = _build_step(lr_scale)

    def _append_metrics(entry: dict) -> None:
        # replayed log boundaries replace, never double-append
        metrics_hist[:] = [e for e in metrics_hist if e["step"] != entry["step"]]
        metrics_hist.append(entry)

    def _gathered() -> dict:
        tree = {"gp": gp, "dp": dp, "g_opt": g_opt, "d_opt": d_opt}
        if mesh is None:
            return tree
        gather = lambda t, sp: SH.gather(t, sp, mesh)  # noqa: E731
        out = {k: SH.map_specs(gather, v, specs[k]) for k, v in tree.items()}
        if comm is not None:
            out["comm"] = OV.CommState(*(tuple(gather(r, w.spec) for r, w in zip(res, ws))
                                         for res, ws in zip(comm, comm_where)))
        return out

    def _save(step_) -> None:
        tree = _gathered()  # every rank takes part in the gather
        if mesh is None or mesh.rank == 0:
            C.save_checkpoint(ckpt_dir, step_, tree, loop_state={
                "step": step_, "lr_scale": lr_scale, "metrics_hist": metrics_hist, "counters": counters,
            })
        if mesh is not None:
            dist.barrier()  # no rank reads the directory before rank 0 has written it

    faulted = False
    preempted = False
    attempts_at: dict[int, int] = {}
    s = start

    def _restore_to_latest() -> None:
        nonlocal gp, dp, g_opt, d_opt, comm, s, metrics_hist
        last, tree = C.restore_latest_valid(ckpt_dir, _like(), device=device, shardings=where,
                                            on_skip=_warn_corrupt)
        if last is None:
            # no (valid) checkpoint yet: restart from init, and drop the
            # metrics history, which belongs to the discarded trajectory
            gp, dp, g_opt, d_opt = _init()
            s = 0
            metrics_hist = []
        else:
            gp, dp, g_opt, d_opt = tree["gp"], tree["dp"], tree["g_opt"], tree["d_opt"]
            s = last
            ls = C.load_loop_state(ckpt_dir, last)
            src = ls.get("metrics_hist", metrics_hist) if ls else metrics_hist
            # replayed steps must not keep stale post-checkpoint entries
            metrics_hist = [e for e in src if e.get("step", 0) <= last]
        if comm is not None:
            comm = OV.init_comm_state(gp_s, dp_s, mesh, **ckw) if last is None else _restore_comm(last)
        if detector is not None:
            detector.reset()

    def _bounded_restore(cause, *, verdict=None, injected=False) -> None:
        """One budgeted restore-and-replay: crashloop detection (the same
        step failing again and again), the run-wide budget, capped
        exponential backoff, then the restore.  Past the budget the fault
        is carried out of the loop as a ``TrainFaultError``."""
        nonlocal lr_scale, step_fn
        attempt = attempts_at.get(s, 0) + 1
        attempts_at[s] = attempt
        total = counters["restores"] + counters["rollbacks"]
        if attempt > pol.max_restores_per_step or total >= pol.max_total_restores:
            why = (f"step {s} failed {attempt} time(s) "
                   f"(budget: {pol.max_restores_per_step}/step, {pol.max_total_restores}/run)")
            if verdict is not None:
                raise R.TrainDivergenceError(why, verdict=verdict, step=s, attempts=attempt, cause=cause)
            raise R.TrainFaultError(why, step=s, kind="crashloop", attempts=attempt, cause=cause) from cause
        if verdict is not None:
            counters["rollbacks"] += 1
        else:
            counters["restores"] += 1
        if injected and verdict is None:
            # injected nan_grad divergences were counted by the sentinel
            # path; only injected raises are counted here
            ih = counters["injected_handled"]
            ih["raise"] = ih.get("raise", 0) + 1
        fault_log.append({
            "step": s, "attempt": attempt, "injected": injected,
            "kind": "divergence" if verdict is not None else "exception",
            "verdict": verdict,
            "action": "rollback" if verdict is not None else "restore",
            "error": None if cause is None else f"{type(cause).__name__}: {cause}",
        })
        wait = pol.backoff(attempt - 1)
        if wait:
            time.sleep(wait)
        _restore_to_latest()
        if verdict is not None and pol.lr_scale != 1.0:
            lr_scale *= pol.lr_scale
            step_fn = _build_step(lr_scale)

    with R.PreemptionGuard(install=handle_signals) as guard:
        while s < steps:
            if _any_rank(guard.requested):
                # preemption-safe exit: one final atomic checkpoint with the
                # loop state, then a clean return
                preempted = True
                if ckpt_dir:
                    _save(s)
                break
            t0 = time.monotonic()
            prev = None
            inj: list = []
            try:
                if hooks.inject_fault_at == s and not faulted:
                    faulted = True
                    raise RuntimeError(f"injected fault at step {s}")
                inj = [kind for kind in (p.draw(step=s, attempt=attempts_at.get(s, 0)) for p in plans) if kind]
                if "preempt" in inj:
                    guard.request()  # honored at the next step boundary
                if "corrupt_ckpt" in inj and ckpt_dir:
                    if mesh is None or mesh.rank == 0:
                        R.corrupt_latest_checkpoint(ckpt_dir)
                    if mesh is not None:
                        dist.barrier()
                if "raise" in inj:
                    raise R.InjectedTrainFault(f"injected raise at step {s}")
                if cfg.z_dim:
                    z = D.latent_batch(seed, s, batch, cfg.z_dim, device=device)
                else:
                    z = D.gan_batch(seed, 1_000_000 + s, batch, cfg.img_hw, device=device)
                real = D.gan_batch(seed, s, batch, cfg.img_hw, device=device)
                if mesh is not None:  # this rank's rows of the global batch
                    z, real = SH.block_of(z, zspec, mesh), SH.block_of(real, rspec, mesh)
                if "nan_grad" in inj:
                    # NaN in the batch -> NaN losses / grads -> a NaN update:
                    # the poisoning a broken kernel or an fp overflow does
                    z = z * float("nan")
                if skip_mode:
                    prev = (gp, dp, g_opt, d_opt, comm)
                if comm is not None:
                    gp, dp, g_opt, d_opt, comm, m = step_fn(gp, dp, g_opt, d_opt, comm, z, real)
                else:
                    gp, dp, g_opt, d_opt, m = step_fn(gp, dp, g_opt, d_opt, z, real)
                if hooks.step_deadline_s and time.monotonic() - t0 > hooks.step_deadline_s:
                    raise TimeoutError(f"step {s} exceeded deadline (straggler)")
            except (RuntimeError, TimeoutError) as e:
                if isinstance(e, R.TrainFaultError):
                    raise  # already carried past a budget: do not re-wrap
                # fault path: restore the newest VALID checkpoint and replay
                # (past a corrupt latest to an older one), within the budget
                if not ckpt_dir:
                    raise
                _bounded_restore(e, injected=isinstance(e, R.InjectedTrainFault))
                continue
            host_m = None
            if detector is not None:
                host_m = _host_metrics(m)
                verdict = detector.observe(s, host_m)
                if verdict is not None:
                    counters["sentinel_trips"] += 1
                    if "nan_grad" in inj and verdict.startswith("nonfinite"):
                        ih = counters["injected_handled"]
                        ih["nan_grad"] = ih.get("nan_grad", 0) + 1
                    if pol.on_divergence == "abort":
                        raise R.TrainDivergenceError(f"sentinel flagged step {s}: {verdict}", verdict=verdict, step=s)
                    if skip_mode:
                        counters["skips"] += 1
                        fault_log.append({
                            "step": s, "kind": "divergence", "verdict": verdict,
                            "action": "skip", "injected": "nan_grad" in inj,
                            "attempt": 0, "error": None,
                        })
                        if counters["skips"] > pol.max_skips:
                            raise R.TrainDivergenceError(
                                f"step {s}: skip budget ({pol.max_skips}) exhausted; last verdict: {verdict}",
                                verdict=verdict, step=s, attempts=counters["skips"],
                            )
                        # discard the update: back to the pre-step trees
                        gp, dp, g_opt, d_opt, comm = prev
                        s += 1
                        continue
                    # rollback
                    if not ckpt_dir:
                        raise R.TrainDivergenceError(
                            f"sentinel flagged step {s} ({verdict}) and the policy says rollback, but there is "
                            "no ckpt_dir to roll back to", verdict=verdict, step=s,
                        )
                    _bounded_restore(None, verdict=verdict, injected="nan_grad" in inj)
                    continue
            if (s + 1) % log_every == 0 or s + 1 == steps:
                hm = host_m if host_m is not None else _host_metrics(m)
                _append_metrics({"step": s + 1, **hm})
                if hooks.on_step:
                    hooks.on_step(s + 1, hm)
            if ckpt_dir and (s + 1) % ckpt_every == 0:
                _save(s + 1)
            s += 1
    final = _gathered()
    return {
        "params": {"gp": final["gp"], "dp": final["dp"]},
        "metrics": metrics_hist,
        "final_step": s,
        "preempted": preempted,
        "counters": counters,
        "fault_log": fault_log,
        "faults_injected": R.plan_totals(plans),
        "lr_scale": lr_scale,
    }
