"""``GanServeEngine``: batched image generation over packed generators.

Each resident arch pays the G-transform and zero-skipping pack once, at
construction, and keeps its packed (C, N, M) weights on the device; a
request then runs only the stem and the deconv trunk: the chained
fused-engine pipeline by default, or per layer with ``chained=False``
(``models.gan.serve_impl`` picks the impl).

Scheduling is the reference's: one shared FIFO queue feeds one pool of
``batch`` slot rows (a request that does not fit the free rows blocks the
queue head), and a dispatch serves every admitted request as one bucketed
generate per resident arch, padded up to the smallest bucket of the ladder
(powers of two up to ``batch``).  ``submit`` returns a ``GanFuture`` whose
``result()`` drives the engine on the caller's thread; there is no
background thread.  Deadline windows, retries, circuit breakers, fault
injection and the async server belong to a later slice.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Optional

import torch

from ..configs.base import GANConfig
from ..models import gan as G

__all__ = ["GanRequest", "GanFuture", "GanServeEngine"]


@dataclasses.dataclass
class GanRequest:
    """One request: a batch of latents (or images for image-to-image
    models) served together, and its outcome."""

    rid: int
    z: torch.Tensor
    arch: Optional[str] = None
    out: Optional[torch.Tensor] = None
    done: bool = False
    failed: bool = False
    error: Optional[BaseException] = None

    @property
    def size(self) -> int:
        return int(self.z.shape[0])

    @property
    def resolved(self) -> bool:
        return self.done or self.failed


class GanFuture:
    """Handle for a submitted request; ``result()`` drives the engine until
    the request is served, then returns its images (or raises its error)."""

    def __init__(self, request: GanRequest, engine: "GanServeEngine"):
        self.request = request
        self._engine = engine

    def done(self) -> bool:
        return self.request.resolved

    def result(self, timeout: Optional[float] = None) -> torch.Tensor:
        req = self.request
        if not req.resolved:
            self._engine._drive_until(req, timeout)
        if req.failed:
            raise req.error
        return req.out


class _Resident:
    """One arch resident on the device: its serving config, packed weights,
    folded batchnorm, per-bucket counts and its generate."""

    def __init__(self, arch: str, gen_params, cfg: GANConfig, device: torch.device, *, chained: bool):
        self.arch = arch
        self.cfg = dataclasses.replace(cfg, deconv_impl=G.serve_impl(cfg.deconv_impl, chained=chained))
        params = {k: {kk: v.to(device, torch.float32).contiguous() for kk, v in d.items()}
                  for k, d in gen_params.items()}
        self.params = G.prepack_generator(params, self.cfg)
        self.folded = G.fold_eval_bn(self.params, self.cfg)  # once, not per request
        self.bucket_counts: dict[int, int] = {}
        self.served = 0
        self.generates = 0

    def generate(self, z: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            img, _ = G.generator_apply(self.params, self.cfg, z, folded=self.folded)
        self.generates += 1
        return img


class GanServeEngine:
    """Image-generation service over one or several resident generators.

    ``GanServeEngine(params, cfg)`` serves one model;
    ``GanServeEngine(models={"dcgan": (params, cfg), ...})`` serves several
    from one shared row pool.  Params are the reference's layout (raw
    ``{"w"}`` or packed ``{"ww"}`` deconv weights) as torch tensors on any
    device; they are moved to ``device`` and packed once here.  Each
    resident runs its generator as one chained pipeline; ``chained=False``
    runs it per layer."""

    def __init__(self, gen_params=None, cfg: Optional[GANConfig] = None, *, models=None,
                 batch: int = 8, buckets: Optional[tuple[int, ...]] = None, device="cuda",
                 chained: bool = True):
        if models is None:
            if gen_params is None or cfg is None:
                raise ValueError("pass (gen_params, cfg) or models={arch: (params, cfg)}")
            models = {cfg.arch_id or "default": (gen_params, cfg)}
        elif gen_params is not None or cfg is not None:
            raise ValueError("pass (gen_params, cfg) OR models=, not both")
        self.device = torch.device(device)
        if buckets is None:
            buckets, b = [], 1
            while b < batch:
                buckets.append(b)
                b *= 2
        # batch is always a bucket: explicit bucket lists refine the padding
        # ladder but never shrink the largest request served
        self.buckets = tuple(sorted({int(b) for b in buckets} | {int(batch)}))
        self.batch = self.buckets[-1]
        self.archs = {arch: _Resident(arch, p, c, self.device, chained=chained) for arch, (p, c) in models.items()}
        self.default_arch = next(iter(self.archs))
        default = self.archs[self.default_arch]
        self.cfg, self.params, self.bucket_counts = default.cfg, default.params, default.bucket_counts

        self.served = 0
        self._lock = threading.RLock()
        self._pending: deque = deque()  # submitted, waiting for free rows
        self.active: list[GanRequest] = []  # admitted, not yet dispatched
        self.rows_used = 0
        self._rid = itertools.count()
        self.dispatch_log: list[tuple[int, ...]] = []  # rids of each dispatch

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

    def _count_bucket(self, res: _Resident, b: int) -> None:
        k = self.bucket_for(b)
        res.bucket_counts[k] = res.bucket_counts.get(k, 0) + 1

    def _run_bucketed(self, res: _Resident, z: torch.Tensor) -> torch.Tensor:
        b = z.shape[0]
        k = self.bucket_for(b)
        if k > b:
            z = torch.cat([z, z.new_zeros((k - b, *z.shape[1:]))])
        imgs = res.generate(z)
        res.served += b
        self.served += b
        return imgs[:b]

    def generate(self, z: torch.Tensor, arch: Optional[str] = None) -> torch.Tensor:
        """z: (b, z_dim) latents (or (b, H, W, 3) images), b <= max bucket.
        Returns the b images of the named resident (or the only one).  The
        bucket counts before the generate runs, as the reference's does: a
        generate that raises still counts (a dispatch counts on success)."""
        res = self.archs[self._resolve_arch(arch)]
        self._count_bucket(res, z.shape[0])
        return self._run_bucketed(res, z.to(self.device, torch.float32))

    # ------------------------------------------------------- admission core
    def _admit_pending(self) -> None:
        """Move submitted requests into the row pool, strict FIFO: stop at
        the first one that does not fit."""
        while self._pending and self.rows_used + self._pending[0].size <= self.batch:
            req = self._pending.popleft()
            self.active.append(req)
            self.rows_used += req.size

    def _dispatch(self) -> list[GanRequest]:
        """Serve every admitted request: snapshot and free the rows under the
        lock, then one bucketed generate per arch aboard.  A failing generate
        resolves its own requests with the error; the others complete."""
        with self._lock:
            batch_reqs, self.active, self.rows_used = self.active, [], 0
            if not batch_reqs:
                return []
            self.dispatch_log.append(tuple(r.rid for r in batch_reqs))
        by_arch: dict[str, list[GanRequest]] = {}
        for r in batch_reqs:
            by_arch.setdefault(r.arch, []).append(r)
        for arch, reqs in by_arch.items():
            try:
                imgs = self._run_bucketed(self.archs[arch], torch.cat([r.z for r in reqs]))
            except Exception as e:  # resolve, never strand, the requests aboard
                for r in reqs:
                    r.failed, r.error = True, e
                continue
            self._count_bucket(self.archs[arch], imgs.shape[0])
            row = 0
            for r in reqs:
                r.out = imgs[row : row + r.size]
                row += r.size
                r.done = True
        return batch_reqs

    # -------------------------------------------------------- futures API
    def submit(self, z: torch.Tensor, *, arch: Optional[str] = None) -> GanFuture:
        """Queue a request; it claims slot rows as soon as they are free and
        is served by the next dispatch."""
        arch_r = self._resolve_arch(arch)
        if int(z.shape[0]) > self.batch:
            raise ValueError(f"request batch {int(z.shape[0])} > engine max bucket {self.batch}")
        req = GanRequest(rid=next(self._rid), z=z.to(self.device, torch.float32), arch=arch_r)
        with self._lock:
            self._pending.append(req)
            self._admit_pending()
        return GanFuture(req, self)

    def _drive_until(self, req: GanRequest, timeout: Optional[float] = None) -> None:
        """Admit and dispatch until ``req`` is resolved."""
        t_end = None if timeout is None else time.monotonic() + timeout
        while not req.resolved:
            with self._lock:
                self._admit_pending()
                ready = bool(self.active)
            if ready:
                self._dispatch()
                continue
            if req.resolved:
                break
            if t_end is not None and time.monotonic() >= t_end:
                raise TimeoutError(f"request {req.rid} not served within {timeout}s")
            time.sleep(0.0005)  # another thread holds the batch

    def run(self, requests: list[torch.Tensor], *, arch: Optional[str] = None) -> list[torch.Tensor]:
        """Serve a queue of variable-size latent batches through the FIFO
        scheduler; outputs come back in request order."""
        futs = [self.submit(z, arch=arch) for z in requests]
        return [f.result() for f in futs]
