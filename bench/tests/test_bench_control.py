"""The control at a size a test run holds: the plain reference computed in
TF32, one precision below the configurations' float32, put in the
program's place, fails the cell's limits, where the program passes them
(``test_bench_faults.py``).  On the chip ``bench/control.py`` reads it at
each cell's own size."""
from __future__ import annotations

import pytest

from bench import control, correctness
from bench.tests._tiny import tiny_cell


@pytest.mark.parametrize("workload", ["dcgan-train-b256", "artgan-train-b256"])
def test_the_tf32_control_fails_a_train_cells_limits(workload):
    cell = tiny_cell(workload, seconds=0.0)
    numbers = control.control_train(cell)
    assert not correctness.passed(correctness.judge(numbers, cell.limits)), numbers


@pytest.mark.parametrize("workload", ["dcgan-serve-c64", "artgan-serve-c64"])
def test_the_tf32_control_fails_a_serve_cells_limits(workload):
    cell = tiny_cell(workload)
    numbers = control.control_serve(cell, 64)
    assert not correctness.passed(correctness.judge(numbers, cell.limits)), numbers
