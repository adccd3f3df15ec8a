"""On the card only (``-m chip``): the control fails at the cells' own
size, and a short run of each cell is correct."""
import time

import pytest

from perfbench import calibrate, harness
from perfbench.run import run_cell

CELLS = ["scannet2v-train", "fvt-wholescene30"]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name, cuda_device, tmp_path):
    cell = harness.load_cell(name)
    limits = cell.workload["limits"]
    control = dict(calibrate.readings(cell, 2**31 + 301, cuda_device, tmp_path))["tf32"]
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name, cuda_device):
    run = run_cell(harness.load_cell(name), 2**31 + 302, 5.0, False, cuda_device,
                   t_start=time.perf_counter())
    assert run.correct and run.failed == 0, [(c.name, c.value) for c in run.checks]
