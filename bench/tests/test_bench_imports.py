"""Nothing under ``bench/`` imports JAX or the JAX package (``repro``),
with each import's top-level name compared whole (the port,
``repro_torch``, begins with the JAX package's name); the plain reference
and the yardstick import nothing of the program."""
from __future__ import annotations

import ast
import sys

from bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_under_bench_imports_jax_or_the_jax_package():
    files = list(harness.BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "yardstick"):
        for f in (harness.BENCH / sub).rglob("*.py"):
            assert "repro_torch" not in _imports(f), f
            assert "repro_torch" not in f.read_text(), f


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro" in harness.forbidden_modules()
