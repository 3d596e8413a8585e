"""Serving engines: ``ServeEngine``, the continuous-batching LM engine
(slots over one shared cache), and ``GanServeEngine``, batched image
generation over packed generators.

``ServeEngine`` (the reference's): B slots share one cache allocated once
at (B, max_len); an arrival fills a free slot by a prefill whose rows are
written into that slot, each decode step runs every slot at its own
position in one batched ``decode_step`` (the reference runs a ``vmap`` of
one-row decodes: the same function), and a finished sequence frees its
slot.  Greedy decoding.

``GanServeEngine``:

Each resident arch pays the G-transform and zero-skipping pack once, at
construction, and keeps its packed (C, N, M) weights on the device; a
request then runs only the stem and the deconv trunk: the chained
fused-engine pipeline by default, or per layer with ``chained=False``
(``models.gan.serve_impl`` picks the impl; a registry entry,
``models.gan.PrepackedGenerator``, keeps a chained or plain impl).

Scheduling is the reference's: one shared FIFO queue feeds one pool of
``batch`` slot rows (a request that does not fit the free rows blocks the
queue head), and a dispatch serves every admitted request as one bucketed
generate per resident arch, padded up to the smallest bucket of the ladder
(powers of two up to ``batch``).  ``deadline_ms`` admits a request into a
batching window that closes when the earliest admitted deadline expires,
the pool fills, or a request without a deadline joins.

Failure semantics are the reference's (``serve.faults``): each arch's
share of a dispatch runs behind its own isolation boundary, with
``FaultPlan`` injection, an optional NaN guard, retries with capped
exponential backoff that never run past a request's deadline, and a
circuit breaker per resident whose half-open probe is refused while the
resident's weights are non-finite.  A failure resolves its requests with a
carried ``GanServeError``; nothing escapes a dispatch.

``submit`` returns a ``GanFuture``: ``result()`` drives the engine on the
caller's thread, or waits on ``serve.loop.AsyncGanServer``'s generate
thread when one is attached.

The one difference from the reference: on CUDA the dispatch synchronizes
the generating thread's current stream before it stamps ``t_done`` (the
reference blocks on its arrays there), so ``compute`` times the generate
on the device and not only its launches.  On the CPU nothing waits.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
from collections import deque
from typing import Optional

import torch
import torch.distributed as dist

from .. import tracing
from ..configs.base import GANConfig, LMConfig
from ..models import gan as G
from ..models import lm as LM
from ..tree import tree_leaves, tree_map
from . import metrics as M
from .faults import CircuitBreaker, FaultPlan, GanServeError, InjectedFault, _now_ms

__all__ = ["Request", "ServeEngine", "GanServeRejected", "GanRequest", "GanFuture", "GanServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list[int]  # prompt
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Greedy-decoding LM engine with ``slots`` slots over one cache.

    The cache is allocated once at (slots, max_len) on the params' device;
    a prompt is cut or zero-padded to ``prompt_len`` and prefilled alone,
    and its rows are written into its slot, so admitting a request never
    reallocates the cache.  ``step`` decodes every slot at its own
    position (``models.lm.decode_step`` with a (slots,) ``cache_len``)."""

    def __init__(self, params, cfg: LMConfig, *, slots: int = 4, max_len: int = 256, prompt_len: int = 32):
        self.params, self.cfg = params, cfg
        self.B, self.max_len, self.prompt_len = slots, max_len, prompt_len
        self.device = params["embed"]["table"].device
        self.cache = LM.init_cache(cfg, slots, max_len, torch.float32, self.device)
        self.pos = [0] * slots  # tokens in each slot's cache
        self.active: list[Optional[Request]] = [None] * slots
        self.last_tok = torch.zeros((slots, 1), dtype=torch.int64, device=self.device)

    def _prefill_one(self, tokens: torch.Tensor):
        with torch.no_grad():
            return LM.prefill(self.params, self.cfg, {"tokens": tokens}, q_chunk=64, max_len=self.max_len)

    def _decode(self, toks: torch.Tensor, lens: torch.Tensor):
        with torch.no_grad():
            return LM.decode_step(self.params, self.cfg, self.cache, toks, lens)

    # ------------------------------------------------------------- admission
    def try_admit(self, req: Request) -> bool:
        for s in range(self.B):
            if self.active[s] is None:
                toks = (list(req.tokens) + [0] * self.prompt_len)[: self.prompt_len]
                logits, cache1 = self._prefill_one(torch.tensor([toks], dtype=torch.int64, device=self.device))
                for key, c in cache1.items():  # slot s's rows from the one-row cache
                    for big, small in zip(self.cache[key], c):
                        big[:, s] = small[:, 0]
                self.pos[s] = min(len(req.tokens), self.prompt_len)
                self.active[s] = req
                first = int(torch.argmax(logits[0]))
                req.out.append(first)  # the prefill step's prediction
                self.last_tok[s, 0] = first
                return True
        return False

    # ----------------------------------------------------------------- step
    def step(self) -> list[Request]:
        """One decode step for every active slot; returns the finished
        requests."""
        if not any(a is not None for a in self.active):
            return []
        lens = torch.tensor(self.pos, dtype=torch.int64, device=self.device)
        logits, _ = self._decode(self.last_tok, lens)  # writes the slots' new rows into self.cache
        nxt = torch.argmax(logits, dim=-1).tolist()
        finished = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = nxt[s]
            req.out.append(tok)
            self.pos[s] += 1
            self.last_tok[s, 0] = tok
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                req.done = True
                finished.append(req)
                self.active[s] = None
                self.pos[s] = 0
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Drive a workload to completion (a simple arrival loop)."""
        pending = list(requests)
        done: list[Request] = []
        while pending or any(a is not None for a in self.active):
            while pending and self.try_admit(pending[0]):
                pending.pop(0)
            done.extend(self.step())
        return done


class GanServeRejected(RuntimeError):
    """The request was refused admission: the bounded inbound queue is
    full, or the target arch is quarantined by its circuit breaker.  The
    message carries the reason."""


@dataclasses.dataclass
class GanRequest:
    """One request: a batch of latents (or images for image-to-image
    models) served together, the arch it targets, its outcome, and four SLO
    stamps (ms, monotonic clock) that ``serve.metrics`` turns into
    queue-wait / batch-wait / compute / end-to-end times."""

    rid: int
    z: torch.Tensor
    arch: Optional[str] = None
    deadline_ms: Optional[float] = None
    out: Optional[torch.Tensor] = None
    done: bool = False
    rejected: bool = False
    failed: bool = False
    error: Optional[BaseException] = None
    reject_reason: Optional[str] = None
    attempts: int = 0
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_dispatch: Optional[float] = None
    t_done: Optional[float] = None
    event: threading.Event = dataclasses.field(default_factory=threading.Event, repr=False, compare=False)

    @property
    def size(self) -> int:
        return int(self.z.shape[0])

    @property
    def resolved(self) -> bool:
        """Every request ends served (``done``), rejected or failed; the
        serve stack's no-hang invariant is that this becomes True for every
        submit."""
        return self.done or self.rejected or self.failed

    @property
    def timing(self) -> Optional[dict]:
        """SLO components (ms) once served; None while in flight."""
        return M.request_timing(self)


class GanFuture:
    """Handle for a submitted request: poll with ``done()``, block with
    ``result(timeout=)``.  With an async server attached
    (``serve.loop.AsyncGanServer``) ``result`` waits for the server's
    generate thread; without one it drives the engine itself."""

    def __init__(self, request: GanRequest, engine: "GanServeEngine"):
        self.request = request
        self._engine = engine

    def done(self) -> bool:
        return self.request.resolved

    def _wait_on_driver(self, timeout: Optional[float]) -> None:
        """Wait for the async server to fulfil the request, watching the
        server: if it detaches mid-wait, drive the engine here; if its loops
        died with no restart coming, fail with ``GanServeError`` rather than
        hang (``result(timeout=None)`` included)."""
        req = self.request
        t_end = None if timeout is None else time.monotonic() + timeout
        while not req.resolved:
            wait = 0.05
            if t_end is not None:
                wait = min(wait, max(0.0, t_end - time.monotonic()))
            if req.event.wait(wait):
                return
            if t_end is not None and time.monotonic() >= t_end:
                raise TimeoutError(f"request {req.rid} not served within {timeout}s")
            drv = self._engine._driver
            if drv is None:  # the server stopped while we waited: drive here
                remaining = None if t_end is None else max(0.0, t_end - time.monotonic())
                self._engine._drive_until(req, remaining)
                return
            if not drv.healthy():
                req.failed = True
                req.error = GanServeError(f"request {req.rid}: serving loop died and will not restart",
                                          arch=req.arch, kind="loop_dead")
                req.event.set()
                return

    def result(self, timeout: Optional[float] = None) -> torch.Tensor:
        req = self.request
        if not req.resolved:
            if self._engine._driver is not None:
                self._wait_on_driver(timeout)
            else:
                self._engine._drive_until(req, timeout)
        if req.rejected:
            raise GanServeRejected(req.reject_reason or f"request {req.rid} rejected (inbound queue full)")
        if req.failed:
            raise req.error if req.error is not None else GanServeError(f"request {req.rid} failed", arch=req.arch)
        return req.out

    def exception(self) -> Optional[BaseException]:
        """The carried failure or rejection, or None in flight or on
        success, without raising."""
        req = self.request
        if req.failed:
            return req.error
        if req.rejected:
            return GanServeRejected(req.reject_reason or f"request {req.rid} rejected (inbound queue full)")
        return None


class _Resident:
    """One arch resident on the device: its serving config, packed weights,
    folded batchnorm, per-bucket counts, its generate, and its failure
    state (circuit breaker and counters).  A registry entry's impl
    (``registered``, already a serving impl) is taken as the reference's
    idempotent ``serve_impl`` takes it: a chained entry stays chained and a
    plain per-layer one (``prepacked_ref``) stays plain on any engine; a
    per-layer kernel entry follows the engine's ``chained``."""

    def __init__(self, arch: str, gen_params, cfg: GANConfig, device: torch.device, *, chained: bool,
                 registered: bool = False, mesh=None, placed: bool = False):
        self.arch = arch
        impl = cfg.deconv_impl
        if not (registered and (G.uses_chained(impl) or impl == "prepacked_ref")):
            impl = G.serve_impl(impl, chained=chained)
        self.cfg = dataclasses.replace(cfg, deconv_impl=impl)
        self.mesh = mesh
        params = tree_map(lambda v: v.to(device, torch.float32).contiguous(), gen_params)
        if placed:  # a registry entry's blocks on this mesh
            self.params = params
        else:
            self.params = G.prepack_generator(params, self.cfg, mesh=mesh)
        # batchnorm leaves are never split, so the blocks fold as the full tree
        self.folded = G.fold_eval_bn(self.params, self.cfg)  # once, not per request
        self.specs = None if mesh is None else G.packed_generator_specs(self.cfg, mesh)
        self.bucket_counts: dict[int, int] = {}
        self.served = 0
        self.generates = 0
        self.breaker = CircuitBreaker()
        self.failures = 0  # dispatches that failed after their retries
        self.retries = 0  # extra generate attempts spent on recovery
        self.nan_trips = 0  # batches the NaN guard refused

    def generate(self, z: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            params = self.params if self.mesh is None else G.gather_params(self.params, self.specs, self.mesh)
            img, _ = G.generator_apply(params, self.cfg, z, folded=self.folded)
        self.generates += 1
        return img

    def resident_bytes(self) -> int:
        """Bytes of the weights this process holds at rest (on a mesh, its
        blocks)."""
        return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(self.params))

    def health_ok(self) -> bool:
        """False while the resident's weights hold a non-finite value: such
        a resident cannot produce a good batch, so the half-open probe is
        refused (``models.gan.params_finite``).  On a mesh the ranks agree:
        one all-reduce of the ranks' answers (every rank asks)."""
        ok = G.params_finite(self.params)
        if self.mesh is None:
            return ok
        flag = torch.tensor([1.0 if ok else 0.0], device=self.mesh.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.mesh.group(self.mesh.axis_names))
        return bool(flag.item() == 1.0)


class GanServeEngine:
    """Image-generation service over one or several resident generators.

    ``GanServeEngine(params, cfg)`` serves one model;
    ``GanServeEngine(models={"dcgan": (params, cfg), ...})`` serves several
    from one shared row pool; a ``models`` value may also be a
    ``models.gan.PrepackedGenerator`` registry entry or an arch-id string
    resolved through ``models.gan.get_prepacked_generator``.  Params are
    the reference's layout (raw ``{"w"}`` or packed ``{"ww"}`` deconv
    weights) as torch tensors on any device; they are moved to ``device``
    and packed once here.  Each resident runs its generator as one chained
    pipeline; ``chained=False`` runs it per layer.

    Failure semantics: a failed per-arch generate is retried up to
    ``max_retries`` times, ``backoff_ms * 2**attempt`` apart (at most
    ``backoff_cap_ms``), never past a request's deadline; each resident
    has a ``CircuitBreaker(threshold=breaker_threshold,
    cooldown_ms=breaker_cooldown_ms)``; ``nan_guard`` refuses a batch with a
    non-finite value; ``fault_plan`` injects faults.

    Sharded residency: with ``mesh`` (``launch.make_mesh``; one process a
    rank, each building this engine with the same full params and
    submitting the same requests in the same order) a resident holds this
    rank's blocks of its packed weights on the mesh's device, placed per
    ``parallel.sharding.gan_param_specs``, and each generate gathers them
    (an ``all_gather`` a split leaf) before it runs the same kernels as the
    single-device engine, so every rank returns the same images.  A
    registry entry built on the same mesh is taken as it is placed.  A
    rank that raises inside a generate leaves the others in the gather,
    which fails them at the process group's timeout."""

    def __init__(self, gen_params=None, cfg: Optional[GANConfig] = None, *, models=None, batch: int = 8,
                 buckets: Optional[tuple[int, ...]] = None, mesh=None, device="cuda", chained: bool = True,
                 max_retries: int = 2, backoff_ms: float = 2.0, backoff_cap_ms: float = 50.0,
                 breaker_threshold: int = 3, breaker_cooldown_ms: float = 250.0, nan_guard: bool = False,
                 fault_plan: Optional[FaultPlan] = None):
        if models is None:
            if gen_params is None or cfg is None:
                raise ValueError("pass (gen_params, cfg) or models={arch: (params, cfg)}")
            models = {cfg.arch_id or "default": (gen_params, cfg)}
        elif gen_params is not None or cfg is not None:
            raise ValueError("pass (gen_params, cfg) OR models=, not both")
        self.device = torch.device(device) if mesh is None else mesh.device
        self.mesh = mesh
        if buckets is None:
            buckets, b = [], 1
            while b < batch:
                buckets.append(b)
                b *= 2
        # batch is always a bucket: explicit bucket lists refine the padding
        # ladder but never shrink the largest request served
        self.buckets = tuple(sorted({int(b) for b in buckets} | {int(batch)}))
        self.batch = self.buckets[-1]
        self.archs: dict[str, _Resident] = {}
        for arch, spec in models.items():
            if isinstance(spec, str):
                spec = G.get_prepacked_generator(spec)
            if isinstance(spec, G.PrepackedGenerator):
                if spec.mesh is not None and spec.mesh is not mesh:
                    raise ValueError(f"{arch!r} was registered as blocks of another mesh; serve it on that mesh")
                res = _Resident(arch, spec.params, spec.cfg, self.device, chained=chained, registered=True,
                                mesh=mesh, placed=spec.mesh is not None)
            else:
                p, c = spec
                res = _Resident(arch, p, c, self.device, chained=chained, mesh=mesh)
            res.breaker = CircuitBreaker(threshold=breaker_threshold, cooldown_ms=breaker_cooldown_ms)
            self.archs[arch] = res
        self.default_arch = next(iter(self.archs))
        default = self.archs[self.default_arch]
        self.cfg, self.params, self.bucket_counts = default.cfg, default.params, default.bucket_counts

        self.served = 0
        self._lock = threading.RLock()
        self._pending: deque = deque()  # submitted, waiting for free rows
        self.active: list[GanRequest] = []  # admitted, not yet dispatched
        self.rows_used = 0
        # earliest absolute deadline (ms) of the admitted requests; None
        # while any admitted request wants immediate service
        self._window_deadline: Optional[float] = None
        self._immediate = False
        self._rid = itertools.count()
        self._driver = None  # serve.loop.AsyncGanServer attaches here
        self.dispatch_log: list[tuple[int, ...]] = []  # rids of each dispatch

        self.max_retries = int(max_retries)
        self.backoff_ms = float(backoff_ms)
        self.backoff_cap_ms = float(backoff_cap_ms)
        self.nan_guard = bool(nan_guard)
        self.fault_plan = fault_plan
        # requests an in-progress dispatch took out of ``active``: the
        # watchdog fails these if the generate thread dies mid-dispatch
        self._inflight: list[GanRequest] = []

    # ------------------------------------------------------------- routing
    def _resolve_arch(self, arch: Optional[str]) -> str:
        if arch is None:
            if len(self.archs) == 1:
                return self.default_arch
            raise ValueError(f"arch= is required on a multi-model engine (resident: {sorted(self.archs)})")
        if arch not in self.archs:
            raise KeyError(f"arch {arch!r} not resident (resident: {sorted(self.archs)})")
        return arch

    def bucket_for(self, b: int) -> int:
        """Smallest serving bucket that fits a size-``b`` request."""
        for k in self.buckets:
            if k >= b:
                return k
        raise ValueError(f"request batch {b} > engine max bucket {self.buckets[-1]}")

    def _padded(self, z: torch.Tensor, k: int) -> torch.Tensor:
        z = z.to(self.device, torch.float32)
        return torch.cat([z, z.new_zeros((k - z.shape[0], *z.shape[1:]))]) if k > z.shape[0] else z

    def generate(self, z: torch.Tensor, arch: Optional[str] = None) -> torch.Tensor:
        """z: (b, z_dim) latents (or (b, H, W, 3) images), b <= max bucket.
        Returns the b images of the named resident (or the only one).  The
        bucket counts before the generate runs, as the reference's does: a
        generate that raises still counts (a dispatch counts on success)."""
        res = self.archs[self._resolve_arch(arch)]
        b = z.shape[0]
        k = self.bucket_for(b)
        res.bucket_counts[k] = res.bucket_counts.get(k, 0) + 1
        imgs = res.generate(self._padded(z, k))
        res.served += b
        self.served += b
        return imgs[:b]

    # ------------------------------------------------------- admission core
    def _admit(self, req: GanRequest, *, deadline_ms: Optional[float] = None, now: Optional[float] = None) -> bool:
        """FIFO admission into the shared row pool; False when the free rows
        cannot fit the request.  ``deadline_ms`` opens or joins the batching
        window; ``now`` (ms) overrides the clock for tests and simulators."""
        if req.size > self.batch:
            raise ValueError(f"request batch {req.size} > engine max bucket {self.batch}")
        if self.rows_used + req.size > self.batch:
            return False
        req.arch = self._resolve_arch(req.arch)
        t = _now_ms(now)
        if req.t_submit is None:
            req.t_submit = t
        req.t_admit = t
        if deadline_ms is None:
            deadline_ms = req.deadline_ms
        self.active.append(req)
        self.rows_used += req.size
        if deadline_ms is None:
            self._immediate = True
        else:
            end = t + deadline_ms
            self._window_deadline = end if self._window_deadline is None else min(self._window_deadline, end)
        return True

    def _admit_pending(self, now: Optional[float] = None) -> int:
        """Move submitted requests into the row pool, strict FIFO: stop at
        the first one that does not fit (it blocks the queue head)."""
        n = 0
        while self._pending and self.rows_used + self._pending[0].size <= self.batch:
            self._admit(self._pending.popleft(), now=now)
            n += 1
        return n

    def window_open(self, now: Optional[float] = None) -> bool:
        """True while the batching window is still collecting: rows are
        admitted, none demanded immediate service, the pool has free rows,
        and the earliest deadline has not expired."""
        if not self.active or self._immediate or self.rows_used >= self.batch:
            return False
        if self._window_deadline is None:
            return False
        return _now_ms(now) < self._window_deadline

    # -------------------------------------------------------- dispatch core
    def _dispatch(self, now: Optional[float] = None) -> list[GanRequest]:
        """Serve every admitted request: take the batch and free the rows
        under the lock (admission can refill the pool meanwhile), then one
        bucketed generate per resident arch aboard, each behind its own
        isolation boundary (``_serve_arch``).  Returns the requests in
        admission order."""
        with self._lock:
            if not self.active:
                return []
            batch_reqs = [r for r in self.active if not r.resolved]
            self.active, self.rows_used = [], 0
            self._window_deadline, self._immediate = None, False
            if not batch_reqs:
                return []
            self.dispatch_log.append(tuple(r.rid for r in batch_reqs))
            dispatch_idx = len(self.dispatch_log) - 1
            self._inflight = batch_reqs
        with tracing.scope("serve.dispatch", ("dispatch", dispatch_idx)):
            t_disp = _now_ms(now)
            for r in batch_reqs:
                r.t_dispatch = t_disp
            by_arch: dict[str, list[GanRequest]] = {}
            for r in batch_reqs:
                by_arch.setdefault(r.arch, []).append(r)
            for arch, reqs in by_arch.items():
                self._serve_arch(arch, reqs, dispatch_idx, now)
            with self._lock:
                self._inflight = []
        return batch_reqs

    def _fail_requests(self, reqs: list[GanRequest], err: BaseException, now: Optional[float] = None) -> None:
        """Carry ``err`` into the requests' futures: a failure resolves, it
        never strands."""
        t = _now_ms(now)
        for r in reqs:
            r.error = err
            r.failed = True
            r.t_done = t
            r.event.set()

    def _generate_checked(self, res: _Resident, z: torch.Tensor, fault: Optional[str], arch: str,
                          attempt: int) -> torch.Tensor:
        """One generate attempt under ``fault``: the batch, waited for on
        the device, NaN-poisoned if the plan says so, and refused by the NaN
        guard (one read of ``isfinite().all()``) when it is on."""
        with tracing.span("serve.generate"):
            imgs = res.generate(z)
        if imgs.is_cuda:  # honest compute stamp: the generate has run, not only launched
            with tracing.sync("serve.sync", "serve/engine.py::GanServeEngine._generate_checked"):
                torch.cuda.current_stream(imgs.device).synchronize()
        if fault == "nan":
            imgs = torch.full_like(imgs, float("nan"))
        if self.nan_guard:
            with tracing.sync("serve.nan_guard", "serve/engine.py::GanServeEngine._generate_checked",
                              when=imgs.is_cuda):
                finite = bool(torch.isfinite(imgs).all())
            if not finite:
                res.nan_trips += 1
                raise GanServeError(f"arch {arch}: non-finite values in generated batch", arch=arch, kind="nan",
                                    attempts=attempt + 1)
        return imgs

    def _serve_arch(self, arch: str, reqs: list[GanRequest], dispatch_idx: int,
                    now: Optional[float] = None) -> None:
        """One resident's share of a dispatch under the failure contract:
        fault injection, the NaN guard, capped exponential-backoff retries
        that never run past a request's absolute deadline (t_submit +
        deadline_ms), and breaker accounting on the final outcome.  No
        exception escapes."""
        res = self.archs[arch]
        pending = list(reqs)
        attempt = 0
        while True:
            plan = self.fault_plan
            for r in pending:
                r.attempts += 1
            b = sum(r.size for r in pending)
            k = self.bucket_for(b)
            try:
                fault = None if plan is None else plan.draw(
                    arch=arch, rids=tuple(r.rid for r in pending), dispatch_idx=dispatch_idx, attempt=attempt)
                if fault == "delay":
                    time.sleep(plan.delay_ms / 1e3)
                elif fault == "raise":
                    raise InjectedFault(f"injected fault (arch={arch}, dispatch={dispatch_idx}, attempt={attempt})")
                imgs = self._generate_checked(res, self._padded(torch.cat([r.z for r in pending]), k), fault, arch,
                                              attempt)
            except Exception as e:  # the isolation boundary: nothing escapes
                retry_ok = attempt < self.max_retries
                backoff_ms = min(self.backoff_ms * (2**attempt), self.backoff_cap_ms)
                t = _now_ms(now)
                survivors, dropped = [], []
                for r in pending:
                    dl = None if r.deadline_ms is None else (r.t_submit or t) + r.deadline_ms
                    (survivors if retry_ok and (dl is None or t + backoff_ms <= dl) else dropped).append(r)
                if dropped:
                    kind = getattr(e, "kind", "exception") if not retry_ok else "deadline"
                    self._fail_requests(dropped, GanServeError(
                        f"arch {arch}: dispatch failed after {attempt + 1} attempt(s): {e}",
                        arch=arch, kind=kind, attempts=attempt + 1, cause=e), now)
                if not survivors:
                    res.failures += 1
                    res.breaker.on_failure(now)
                    return
                res.retries += 1
                attempt += 1
                pending = survivors
                if now is None:
                    time.sleep(backoff_ms / 1e3)
                continue
            # success: the resident's health gates half-open re-admission, so
            # a probe through poisoned weights does not close the breaker
            if res.breaker.state == "half_open" and not res.health_ok():
                res.failures += 1
                res.breaker.on_failure(now)
                self._fail_requests(pending, GanServeError(
                    f"arch {arch}: resident weights are non-finite", arch=arch, kind="weights",
                    attempts=attempt + 1), now)
                return
            res.bucket_counts[k] = res.bucket_counts.get(k, 0) + 1
            res.served += b
            self.served += b
            t_done = _now_ms(now)
            row = 0
            for r in pending:
                r.out = imgs[row : row + r.size]
                row += r.size
                r.t_done = t_done
                r.done = True
                r.event.set()
            res.breaker.on_success()
            return

    # -------------------------------------------------------------- health
    def health(self) -> dict:
        """Serve health per arch: breaker state and the failure / retry /
        NaN-trip / served counters (``serve.metrics.summarize(counters=)``
        merges them into its rows)."""
        return {arch: {**res.breaker.counters(), "failures": res.failures, "retries": res.retries,
                       "nan_trips": res.nan_trips, "served": res.served}
                for arch, res in self.archs.items()}

    # -------------------------------------------------------- futures API
    def submit(self, z: torch.Tensor, *, arch: Optional[str] = None, deadline_ms: Optional[float] = None,
               now: Optional[float] = None) -> GanFuture:
        """Queue a request and get a ``GanFuture`` back.  It claims slot
        rows as soon as they are free and is generated when its batching
        window closes.  ``deadline_ms`` bounds the coalescing delay it
        tolerates (none: served at the next dispatch).  A quarantined arch
        fast-rejects with a reasoned ``GanServeRejected``."""
        arch_r = self._resolve_arch(arch)
        if int(z.shape[0]) > self.batch:
            raise ValueError(f"request batch {int(z.shape[0])} > engine max bucket {self.batch}")
        ok, reason = self.archs[arch_r].breaker.allow_submit(now)
        if not ok:
            raise GanServeRejected(f"arch {arch_r!r}: {reason}")
        rid = next(self._rid)
        with tracing.span("serve.submit", owner=("request", rid)):
            with tracing.sync("serve.latents", "serve/engine.py::GanServeEngine.submit",
                              when=self.device.type == "cuda" and not z.is_cuda):
                z = z.to(self.device, torch.float32)
            req = GanRequest(rid=rid, z=z, arch=arch_r, deadline_ms=deadline_ms, t_submit=_now_ms(now))
            with self._lock:
                self._pending.append(req)
                self._admit_pending(now)
        return GanFuture(req, self)

    def _drive_until(self, req: GanRequest, timeout: Optional[float] = None) -> None:
        """The synchronous drive behind ``GanFuture.result()``: admit and
        dispatch as windows close until ``req`` is resolved, sleeping out
        windows still open."""
        t_end = None if timeout is None else time.monotonic() + timeout
        while not req.resolved:
            with self._lock:
                self._admit_pending()
                open_ = self.window_open()
                ready = bool(self.active) and not open_
                window_wait_s = (max(0.0, self._window_deadline / 1e3 - time.monotonic())
                                 if open_ and self._window_deadline is not None else None)
            if ready:
                self._dispatch()
                continue
            if req.resolved:
                break
            if t_end is not None and time.monotonic() >= t_end:
                raise TimeoutError(f"request {req.rid} not served within {timeout}s")
            # a window still open (sleep it out) or another thread holds the
            # batch: yield briefly, bounded so timeouts stay responsive
            wait = 0.0005 if window_wait_s is None else window_wait_s
            if t_end is not None:
                wait = min(wait, max(0.0, t_end - time.monotonic()))
            time.sleep(min(wait, 0.05))

    # --------------------------------------------------- deprecated surface
    def try_admit(self, req: GanRequest, *, deadline_ms: Optional[float] = None,
                  now: Optional[float] = None) -> bool:
        """Deprecated: use ``submit``.  Claim ``req.size`` free rows for the
        next dispatch; False when the pool cannot fit the request."""
        warnings.warn("GanServeEngine.try_admit is deprecated; use submit(z, arch=..., deadline_ms=...) -> GanFuture",
                      DeprecationWarning, stacklevel=2)
        with self._lock:
            return self._admit(req, deadline_ms=deadline_ms, now=now)

    def poll(self, now: Optional[float] = None) -> list[GanRequest]:
        """Deprecated: use ``submit(...).result()``.  Serve the admitted
        batch if its window has closed; [] while it is open."""
        warnings.warn("GanServeEngine.poll is deprecated; GanFuture.result() (or serve.loop.AsyncGanServer) "
                      "drives the engine", DeprecationWarning, stacklevel=2)
        with self._lock:
            if not self.active or self.window_open(now):
                return []
        return self._dispatch(now)

    def step(self) -> list[GanRequest]:
        """Deprecated: use ``submit(...).result()``.  Serve every admitted
        request now and free all rows."""
        warnings.warn("GanServeEngine.step is deprecated; GanFuture.result() (or serve.loop.AsyncGanServer) "
                      "drives the engine", DeprecationWarning, stacklevel=2)
        return self._dispatch()

    def run(self, requests: list[torch.Tensor], *, arch: Optional[str] = None) -> list[torch.Tensor]:
        """Serve a queue of variable-size latent batches through the FIFO
        scheduler; outputs come back in request order."""
        futs = [self.submit(z, arch=arch) for z in requests]
        return [f.result() for f in futs]
