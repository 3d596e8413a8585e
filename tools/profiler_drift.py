#!/usr/bin/env python3
"""Whether ``torch.profiler`` keeps every kernel record of a short session
late in a process: TPU kernel 8's CUDA kernel (``engine1d.cu`` out mode 0,
the audio decoder's deconv0, as ``chip_smoke.py``'s ``costs`` phase calls
it) profiled in sessions of 3 and 10 calls, then launched unprofiled for
``--idle-s`` seconds, then profiled again.  One JSON line a session: the
kernel records kept, the launch calls recorded, each kept record's start
less its own launch's (us, matched in order where none was lost) and the
device ms a call.  ``--teardown`` tears CUPTI down after every session
(``TEARDOWN_CUPTI=1`` while it stops): that keeps a lone process's later
sessions whole but for the first, and did not keep ``chip_smoke.py``'s
(whose ``costs`` phase runs in a fresh process instead); the script leaves
through ``os._exit``, since the teardown leaves the interpreter's
finalization hanging.

    python3 tools/profiler_drift.py [--idle-s 150] [--teardown]    # on a card
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--idle-s", type=float, default=150.0)
    ap.add_argument("--teardown", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiler_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as CS
    from repro_torch.configs import audio_decoder
    from repro_torch.core.winograd import get_transform
    from repro_torch.kernels import _build, engine, ops

    _build.load_library()
    sp = audio_decoder(CS.AUDIO_WIDTH)[0]
    g = torch.Generator(device="cuda").manual_seed(700)
    x = torch.randn((CS.AUDIO_BATCH, CS.AUDIO_FRAMES, sp.c_in), generator=g, device="cuda")
    packed = ops.prepack_deconv1d(0.05 * torch.randn((sp.dims.kernel, sp.c_in, sp.c_out), generator=g,
                                                     device="cuda"), sp.dims)
    cells, ty = ops.deconv1d_cells_from_seq(x, sp.dims)
    pos_idx, sub_slices, _, _ = ops.packed_deconv1d_layout(sp.dims)
    bt = tuple(tuple(float(v) for v in row) for row in get_transform(2, 3).BT)

    def k8():
        return engine.winograd_conv1d_fused_engine(cells, packed.ww, packed.inv, bt, pos_idx=pos_idx,
                                                   sub_slices=sub_slices, m=2, n=4, ty=ty, out_mode="scratch")

    def session(when: str, reps: int) -> None:
        for _ in range(3):
            k8()
        torch.cuda.synchronize()
        if args.teardown:
            os.environ["TEARDOWN_CUPTI"] = "1"
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                k8()
            torch.cuda.synchronize()
        os.environ.pop("TEARDOWN_CUPTI", None)
        evs = prof.events()
        kern = sorted((e for e in evs if e.device_type == DeviceType.CUDA and CS.kernel_named(e.name, CS.ENGINE1D_KERNELS)),
                      key=lambda e: e.time_range.start)
        launch = sorted((e for e in evs if e.device_type != DeviceType.CUDA and "LaunchKernel" in e.name),
                        key=lambda e: e.time_range.start)
        # each kept record against its launch, matched in order (None where records were lost)
        skew = [round(k.time_range.start - c.time_range.start, 1) for k, c in zip(kern, launch)] \
            if len(kern) == len(launch) else None
        print(json.dumps({"when": when, "teardown": args.teardown, "reps": reps, "kernel_records": len(kern),
                          "launch_calls": len(launch), "skew_us": skew,
                          "kernel_ms_a_call": sum(k.time_range.elapsed_us() for k in kern) / 1e3 / reps}), flush=True)

    for reps in (3, 10):
        session("start", reps)
    t0 = time.time()
    n = 0
    while time.time() - t0 < args.idle_s:
        for _ in range(100):
            k8()
        torch.cuda.synchronize()
        n += 100
    print(json.dumps({"idle_s": time.time() - t0, "idle_launches": n}), flush=True)
    for reps in (3, 10, 3, 10):
        session("after_idle", reps)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
