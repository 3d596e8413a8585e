"""Traffic kind ``train_steps``: the port's GAN train step, back to back.

Set-up builds one trainer (``make_gan_step`` with its packed parameters and
AdamW states) and drives it through the mix's ``checked_steps`` first steps
by the window's own call, on a fresh latent batch and the next batch of the
real-image pool each: those steps warm every shape and are the ones the
reference follows.  The window then calls the same trainer until
``--seconds`` have passed on the host's clock and ends in
``torch.cuda.synchronize()``; nothing is read to the host inside it.

Mix keys: ``batch``, ``real_pool`` (device batches of real images, cycled),
``deconv_impl`` / ``conv_impl`` (the port's impls), ``lr``, ``b1``,
``checked_steps``.
"""
from __future__ import annotations

import statistics
import time
import traceback
import warnings

import torch

from .. import correctness, devices, inputs, profiling, program
from ..reference import gan as R
from ..yardstick import flops

PROFILED_STEPS = 3  # a short, early stretch: the profiler loses records late in a process
HOST_SAMPLES = 5


def make_feed(cfg: dict, tr: dict, seed: int, dev):
    """(the latents' generator, the real-image pool) of a run: the pool is
    drawn first, then one latent batch a step from the same generator."""
    feed = torch.Generator(device=dev).manual_seed(inputs.stream_seed(seed, 2))
    hw, ch = cfg["img_hw"], cfg["img_ch"]
    return feed, torch.rand((tr["real_pool"], tr["batch"], hw, hw, ch), generator=feed, device=dev) * 2 - 1


def _host(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def run(cell) -> dict:
    from repro_torch.models import gan as G
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepSettings, make_gan_step

    tr, cfg, dev = cell.traffic, cell.cfg, cell.device
    cuda = torch.device(dev).type == "cuda"
    B, n_checked = tr["batch"], tr["checked_steps"]
    pcfg = program.gan_config(cfg, deconv_impl=tr["deconv_impl"], conv_impl=tr["conv_impl"])

    raw_g, raw_d = inputs.draw_params(cfg, cell.seed, dev)
    feed, pool = make_feed(cfg, tr, cell.seed, dev)

    gp = G.prepack_generator(inputs.nest(raw_g), pcfg)
    dp = G.prepack_discriminator(inputs.nest(raw_d), pcfg)
    step = make_gan_step(pcfg, settings=StepSettings(lr=tr["lr"], b1=tr["b1"]))
    step = cell.hooks.get("wrap_step", lambda s: s)(step)
    state = [gp, dp, adamw_init(gp), adamw_init(dp)]
    calls = [0]

    def call():
        z = torch.randn((B, cfg["z_dim"]), generator=feed, device=dev)
        out = step(*state, z, pool[calls[0] % len(pool)])
        state[:] = out[:4]
        calls[0] += 1
        return z, out[4]

    # the checked first steps, through the window's own call; each step's
    # update is held against AdamW on its own moments as it is made (its
    # time is the check's, not set-up's)
    params = lambda: {**inputs.flatten(state[0]), **inputs.flatten(state[1])}  # noqa: E731
    moments = lambda i: {**inputs.flatten(getattr(state[2], i)), **inputs.flatten(getattr(state[3], i))}  # noqa: E731
    prog = {"p0": _host(params()), "losses": [], "update_gap": 0.0}
    trainable = [k for k in prog["p0"] if not R.is_running_stat(k)]
    zs, reals, losses = [], [], []
    check_s = 0.0
    for s in range(n_checked):
        reals.append(pool[calls[0] % len(pool)].to("cpu", copy=True))
        before = {k: v.detach().clone() for k, v in params().items()}
        z, m = call()
        zs.append(z.to("cpu", copy=True))
        losses.append((m["g_loss"], m["d_loss"]))
        t = time.perf_counter()
        gap = correctness.update_gap(before, params(), moments("m"), moments("v"), s + 1, trainable, lr=tr["lr"],
                                     b1=tr["b1"])
        prog["update_gap"] = correctness.worst([prog["update_gap"], gap])
        del before
        check_s += time.perf_counter() - t
        if s == 0:
            prog["grad"] = {k: v.detach().to("cpu", copy=True) / (1 - tr["b1"]) for k, v in moments("m").items()}
    prog["p_end"] = _host(params())
    prog["losses"] = [(float(g), float(d)) for g, d in losses]
    raw = (_host(raw_g), _host(raw_d))
    del raw_g, raw_d, gp, dp

    # the window
    stretches: list = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start - check_s
    t_end = t0 + cell.seconds
    steps = 0
    if cell.trace:
        with profiling.stretch(dev, stretches):
            for _ in range(PROFILED_STEPS):
                with profiling.span("step"):
                    call()
                steps += 1
    t_free = time.perf_counter()
    steps_free = 0
    while time.perf_counter() < t_end:
        call()
        steps_free += 1
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps += steps_free
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stretches = profiling.finish(stretches)

    ctx = {"cfg": cfg, "device_name": devices.name(dev), "flops_per_step": flops.train_step_flops(cfg, B),
           "steps_free": steps_free, "seconds_free": t1 - t_free, "stretch": stretches[0] if stretches else None,
           "training": True}
    if cell.trace:
        ctx["step_host_ms"] = statistics.median(_enqueue_ms(call, cuda) for _ in range(HOST_SAMPLES))
        _log_syncs_in_step(call, cuda, cell.log)
    state.clear()
    del step, pool
    if cuda:
        torch.cuda.empty_cache()

    ref = follow(cfg, raw, zs, reals, lr=tr["lr"], b1=tr["b1"], device=dev)
    numbers = correctness.train_numbers(prog, ref)
    return {
        "e2e": {"train_images_per_s": steps * B / (t1 - t0), "peak_device_gib": peak / 2**30, "setup_s": setup_s},
        "ctx": ctx,
        "numbers": numbers,
        "attempted": steps + n_checked,
        "failed": 0,
        "device": devices.describe(dev, peak, stretches),
        "breakdown": profiling.breakdown(stretches[0]) if stretches else None,
    }


def follow(cfg: dict, raw, zs, reals, *, lr: float, b1: float, device, tf32: bool = False) -> dict:
    """The plain reference's run of the checked steps from the same raw
    weights, latents and images: its losses, step 1's gradient, its packed
    start and end, and its own updates' ``update_gap``.  The reference packs
    the raw weights itself."""
    with R.fp32_products():
        g = {k: v.to(device) for k, v in raw[0].items()}
        d = {k: v.to(device) for k, v in raw[1].items()}
        gp, dp = R.pack_params(g, d, cfg)
        out = {"p0": {**gp, **dp}, "losses": [], "trainable": [k for k in {**gp, **dp} if not R.is_running_stat(k)]}
        g_opt, d_opt = R.adam_init(gp), R.adam_init(dp)
        out["update_gap"] = 0.0
        for s, (z, real) in enumerate(zip(zs, reals)):
            before = {**gp, **dp}
            gp, dp, g_opt, d_opt, gl, dl, gg, dg = R.train_step(gp, dp, g_opt, d_opt, z.to(device), real.to(device),
                                                               cfg, lr=lr, b1=b1, tf32=tf32)
            out["losses"].append((float(gl), float(dl)))
            gap = correctness.update_gap(before, {**gp, **dp}, {**g_opt["m"], **d_opt["m"]},
                                         {**g_opt["v"], **d_opt["v"]}, s + 1, out["trainable"], lr=lr, b1=b1)
            out["update_gap"] = correctness.worst([out["update_gap"], gap])
            if s == 0:
                out["grad"] = {**gg, **dg}
        out["p_end"] = {**gp, **dp}
    return out


def _enqueue_ms(call, cuda: bool) -> float:
    """Host milliseconds of one step call on an idle queue, not waited for."""
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    call()
    return 1e3 * (time.perf_counter() - t)


def _log_syncs_in_step(call, cuda: bool, log) -> None:
    """Log how often one step call waits for the device and where it first
    does (torch's sync debug mode; its "error" setting raises at the first
    synchronizing call, so that call is made after the window, its state
    dropped)."""
    if not cuda:
        return
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
        where = "nowhere"
    except RuntimeError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__) if "repro_torch" in f.filename]
        f = frames[-1] if frames else None
        where = f"{f.filename.rsplit('src/', 1)[-1]}:{f.lineno} ({f.line})" if f else "?"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"bench: a step call synchronizes {n} time(s); first at {where}")
