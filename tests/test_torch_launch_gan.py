"""The launcher's GAN path on the CPU: ``launch/train.py``'s ``main([...
"--arch", "dcgan", "--smoke", "--device", "cpu", "--steps", "2"])`` with
``REGISTRY["dcgan"]`` swapped for ``tiny_dcgan()`` (as the reference's mini
dry run shrinks its cell).  Its metrics are finite, and the step it runs
is ``build_gan_step``'s: built once, called once a step, on this rank's
blocks under ``meta["in_specs"]``."""
from __future__ import annotations

import math
import re

import torch.distributed as dist

from repro_torch import configs as TCFG
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT


def test_launcher_gan_path_runs_build_gan_steps_step(monkeypatch, capsys):
    monkeypatch.setitem(TCFG.REGISTRY, "dcgan", TCFG.tiny_dcgan())
    built, calls = [], []

    def counted(cfg, mesh, **kw):
        fn, args, meta = TS.build_gan_step(cfg, mesh, **kw)
        built.append((cfg, meta))

        def step(*a):
            calls.append(a)
            return fn(*a)

        return step, args, meta

    monkeypatch.setattr(TT, "build_gan_step", counted)
    TT.main(["--arch", "dcgan", "--smoke", "--device", "cpu", "--steps", "2"])
    assert not dist.is_initialized()  # the launcher tears down the world of 1 it made
    out = capsys.readouterr().out
    losses = [(float(g), float(d)) for g, d in re.findall(r"step \d+: g=(\S+) d=(\S+)", out)]
    assert len(losses) == 2 and all(math.isfinite(v) for pair in losses for v in pair), out
    assert "done" in out
    assert len(built) == 1 and built[0][0] is TCFG.REGISTRY["dcgan"] and len(calls) == 2
    assert len(built[0][1]["in_specs"]) == len(calls[0]) == 6  # gp, dp, both AdamW states, z, real
