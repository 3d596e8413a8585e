"""A whole run, its look for a card skipped, at a tiny size on the CPU:
sound, it comes out correct under the cell's own limits; with the timed
path broken underneath, once for each fault the cell can have, it comes
out not correct.  (One chip: no exchange between chips to leave out.)"""
from __future__ import annotations

import pytest

from bench import control, harness
from bench.tests._tiny import tiny_cell

CASES = [("dcgan-train-b256", None), ("dcgan-train-b256", "half_batch"), ("dcgan-train-b256", "unchanged_state"),
         ("dcgan-train-b256", "stale_leaf"),
         ("dcgan-serve-c64", None), ("dcgan-serve-c64", "half_batch"), ("dcgan-serve-c64", "altered_answer")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_correct_only_while_the_timed_path_is_sound(workload, fault):
    cell = tiny_cell(workload, seconds=0.0 if "train" in workload else 0.3)
    if fault:
        hook, wrap = control.FAULTS[cell.traffic["kind"]][fault]
        cell.hooks = {hook: wrap}
    result, readings = harness.run_cell(cell, harness.spec())
    assert result["correct"] is (fault is None), readings
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(cell.limits)
