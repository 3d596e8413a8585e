"""Traffic kind ``closed_loop``: clients that each keep one request in
``GanServeEngine`` and send the next when its images have come back.

One thread plays every client: it drives the engine through the oldest
open request's ``GanFuture.result()`` (one dispatch of up to ``pool_rows``
rows), copies each served request's images to host memory, and sends that
client's next request.  A request's time runs from its ``submit`` to its
images in host memory.  Each client cycles through the mix's ``sizes`` in
an order drawn from the seed for every round, so every seed offers the
same work.

Set-up warms every serving bucket the loop can reach, then runs the loop
for ``warm_seconds`` and at least ``WARM_DISPATCHES`` dispatches (the
host runs the loop's first second about a third faster than the rest, so
a window that held it would read higher the shorter it is); the window
opens on the running loop and closes ``--seconds`` later.  Requests still open then are served and
checked, and not counted.

Mix keys: ``clients``, ``sizes``, ``pool_rows`` (the engine's batch),
``deconv_impl``, ``deadline_ms`` (None: served at the next dispatch),
``warm_seconds`` (the loop's run before the window),
``sample_every`` (one request in this many is kept for the check, and the
first of the largest size).
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import correctness, devices, inputs, profiling, program
from ..reference import gan as R
from ..yardstick import flops, stats

WARM_DISPATCHES = 20
PROFILED_DISPATCHES = 8  # a short, early stretch: the profiler loses records late in a process
REF_BLOCK = 512  # images a reference generate


class Clients:
    """Every client's request sizes and latents, from the seed."""

    def __init__(self, tr: dict, z_dim: int, seed: int):
        self.sizes, self.z_dim = list(tr["sizes"]), z_dim
        self.rng = np.random.default_rng(inputs.stream_seed(seed, 3))
        self.queues = [collections.deque() for _ in range(tr["clients"])]

    def next(self, c: int) -> torch.Tensor:
        q = self.queues[c]
        if not q:
            q.extend(self.rng.permutation(self.sizes).tolist())
        return torch.from_numpy(self.rng.standard_normal((q.popleft(), self.z_dim), dtype=np.float32))


class Counts:
    """What the window saw from a point on: images, requests' latencies and
    queue waits, and the engine's rows dispatched and images served."""

    def __init__(self, engine, t: float):
        self.t, self.engine = t, engine
        self.buckets0, self.served0 = dict(engine.bucket_counts), engine.served
        self.images, self.lat_ms, self.wait_ms, self.failed = 0, [], [], 0

    def add(self, req, t_sub: float, t_done: float, ok: bool) -> None:
        if ok:
            self.images += req.size
            self.lat_ms.append(1e3 * (t_done - t_sub))
            self.wait_ms.append(req.t_dispatch - req.t_submit)
        else:
            self.lat_ms.append(float("inf"))
            self.failed += 1

    def rows(self) -> tuple[int, int]:
        """(rows dispatched, images served) by the engine since ``t``."""
        e = self.engine
        rows = sum(k * (n - self.buckets0.get(k, 0)) for k, n in e.bucket_counts.items())
        return rows, e.served - self.served0


def run(cell) -> dict:
    from repro_torch.serve.engine import GanServeEngine

    tr, cfg, dev = cell.traffic, cell.cfg, cell.device
    cuda = torch.device(dev).type == "cuda"
    pcfg = program.gan_config(cfg, deconv_impl=tr["deconv_impl"])
    raw_g, _ = inputs.draw_params(cfg, cell.seed, dev)
    engine = GanServeEngine(inputs.nest(raw_g), pcfg, batch=tr["pool_rows"], device=dev)
    raw_g = {k: v.to("cpu", copy=True) for k, v in raw_g.items()}
    for res in engine.archs.values():
        res.generate = cell.hooks.get("wrap_generate", lambda g: g)(res.generate)

    # every bucket the loop can reach: its open rows never fall below what
    # the clients hold at the least
    low = engine.bucket_for(min(engine.batch, tr["clients"] * min(tr["sizes"])))
    for k in (b for b in engine.buckets if b >= low):
        for _ in range(2):
            engine.generate(torch.zeros((k, cfg["z_dim"]))).cpu()

    clients = Clients(tr, cfg["z_dim"], cell.seed)
    largest = max(tr["sizes"])
    open_: collections.deque = collections.deque()  # (client, t_submit, z, future), oldest first
    sample: list = []
    stretches: list = []
    window = free = prof = None
    attempted = dispatches = 0
    t_close = end_rows = None

    def submit(c: int) -> None:
        z = clients.next(c)
        with profiling.span("submit"):
            t = time.perf_counter()
            fut = engine.submit(z, deadline_ms=tr["deadline_ms"])
        open_.append((c, t, z, fut))

    t_warm = time.perf_counter() + tr["warm_seconds"]
    for c in range(tr["clients"]):
        submit(c)
    while open_:
        if window is None and dispatches >= WARM_DISPATCHES and time.perf_counter() >= t_warm:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            window = free = Counts(engine, time.perf_counter())
            t_close = window.t + cell.seconds
            attempted, opened = len(open_), dispatches
            if cell.trace:
                prof = profiling.stretch(dev, stretches)
                prof.__enter__()
        if prof is not None and dispatches == opened + PROFILED_DISPATCHES:
            prof.__exit__(None, None, None)
            prof, free = None, Counts(engine, time.perf_counter())
        with profiling.span("dispatch"):
            try:
                open_[0][3].result()
            except Exception:  # a failed request is counted below, and misses every limit
                pass
        dispatches += 1
        while open_ and open_[0][3].done():
            c, t_sub, z, fut = open_.popleft()
            ok = fut.exception() is None
            if ok:
                with profiling.span("copy_out"):
                    imgs = fut.result().cpu()
            t_done = time.perf_counter()
            if window is not None and t_done > t_close and end_rows is None:
                end_rows = free.rows()
            if window is not None and t_done <= t_close:
                for counts in {id(window): window, id(free): free}.values():
                    counts.add(fut.request, t_sub, t_done, ok)
            if ok and window is not None and (fut.request.rid % tr["sample_every"] == 0 or (
                    z.shape[0] == largest and not any(s.shape[0] == largest for s, _ in sample))):
                sample.append((z, imgs))
            if window is None or t_done <= t_close:
                submit(c)
                attempted += window is not None
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stretches = profiling.finish(stretches)
    rows, served = end_rows or free.rows()
    ctx = {"cfg": cfg, "device_name": devices.name(dev), "stretch": stretches[0] if stretches else None,
           "training": False, "images_free": free.images,
           "seconds_free": t_close - free.t, "flops_per_image": flops.generate_flops(cfg, 1),
           "rows_dispatched": rows, "images_dispatched": served, "queue_wait_ms": free.wait_ms}
    del engine
    if cuda:
        torch.cuda.empty_cache()

    gap = float("inf")  # no answer to check misses the limit
    if sample:
        ref = generate(cfg, raw_g, torch.cat([z for z, _ in sample]), device=dev)
        gap = correctness.image_gap(torch.cat([im for _, im in sample]), ref)
    return {
        "e2e": {"serve_images_per_s": window.images / cell.seconds,
                "serve_p95_ms": stats.percentile(window.lat_ms, 95) if window.lat_ms else float("inf"),
                "peak_device_gib": peak / 2**30, "setup_s": window.t - cell.t_start},
        "ctx": ctx,
        "numbers": {"image_gap": gap},
        "attempted": attempted,
        "failed": window.failed,
        "missing": window.failed,
        "device": devices.describe(dev, peak, stretches),
        "breakdown": profiling.breakdown(stretches[0]) if stretches else None,
    }


def generate(cfg: dict, raw_g: dict, z: torch.Tensor, *, device, tf32: bool = False) -> torch.Tensor:
    """The plain reference's images of latents ``z`` (eval mode, raw
    weights, ``F.conv_transpose2d``), in blocks, on the host."""
    with R.fp32_products(), torch.no_grad():
        p = {k: v.to(device) for k, v in raw_g.items()}
        return torch.cat([R.generator(p, cfg, z[i : i + REF_BLOCK].to(device), training=False, packed=False,
                                      tf32=tf32)[0].cpu() for i in range(0, z.shape[0], REF_BLOCK)])
