"""The control: the reference in the program's place, one precision down.

The configurations state bfloat16 compute; the nearest precision below
it is float8: the reference with what each convolution and linear
layer reads and returns rounded to e4m3, and the gradient at each
layer's output to e5m2, each at a per-tensor scale.  Compared with the
float32 reference as the program is, it fails the committed limits (its
first step's forward reads about ten times the program's
``forward_gap``), and so does the half-batch fault planted in the
reference, while the program passes.  Here on the CPU at the published
widths with a batch a test run holds; the readings at the cells' own
sizes on the card are in PERF.md, from ``portbench/calibrate.py``."""

import pytest
import torch

from portbench.harness import cell as cell_mod
from portbench.harness import check
from portbench.tests.tiny import tiny_cell

CONTROLS = [("geese_ring_b16k", "fp8", 32), ("grf_ring_b20k", "fp8", 8)]


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("workload,precision,windows", CONTROLS)
@pytest.mark.parametrize("seed", [5, 6])
def test_control_and_fault_fail_the_limits(workload, precision, windows,
                                           seed):
    cell = tiny_cell(workload, windows=windows, full_width=True)
    device = torch.device("cpu")
    run = cell_mod.start(cell, seed, device)
    run.learner.stop()
    run.trainer = run.learner = run.marks = None
    numbers, ref = cell_mod.readings(cell, run, device)
    assert check.judge(numbers, cell.limits)[0], numbers
    episode_of = list(range(len(run.sources)))
    for planted in ({"precision": precision}, {"half": True}):
        steps = check.reference_steps(cell, run.init, run.sources,
                                      episode_of, run.draws, device,
                                      **planted)
        numbers = check.compare(cell, steps, ref, run.init)
        numbers["bad_draws"] = 0
        correct, compared = check.judge(numbers, cell.limits)
        assert not correct, (planted, compared)
