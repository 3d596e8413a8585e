"""A run that finds no card fails and prints no result: it never falls
back to the CPU; nor does a run in a directory that holds only
``BENCHMARK.json`` and ``bench/``."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

from bench import harness

ARGS = ["--workload", "dcgan-serve-c64", "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "0"]


def _run(root, env=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})}
    return subprocess.run([sys.executable, os.path.join(root, "bench", "run.py"), *ARGS], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)


def _assert_refused(p):
    assert p.returncode != 0
    assert not [line for line in p.stdout.splitlines() if line.startswith("{")]


def test_a_run_without_a_card_fails():
    p = _run(str(harness.ROOT))
    _assert_refused(p)
    assert "CUDA device" in p.stderr


def test_a_run_from_the_benchmarks_files_alone_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    _assert_refused(_run(str(tmp_path), {"PYTHONPATH": ""}))
