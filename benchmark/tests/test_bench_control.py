"""The control: the plain reference computed in float8 in the program's
place has to come out as not correct, against each cell's limits. On the
CPU at a tiny size; on the card at the cell's own size (marked ``cuda``:
one seed, a short window)."""
import time

import pytest

from harness import core
from tiny import bench, run_cell

CELLS = [w["name"] for w in bench()["workloads"]]


def _fails(run, control):
    """Whether the control's readings fail one of the cell's limits."""
    limits = run.traffic["limits"]
    readings = control.get("fp8", control)
    return any(readings[k] > limits[k] for k in readings if k in limits)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_a_tiny_cell(workload):
    run, control = run_cell(workload, control=True)
    assert run.correct
    assert _fails(run, control), (control, run.traffic["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cell_size(workload, cuda_device):
    cell = core.Cell.find(workload)
    seconds = {"sample": 8.0, "train": 1.0, "serve": 10.0}[
        cell.traffic["driver"]]
    run = core.Run(cell, 20261017, seconds, False, cuda_device,
                   time.perf_counter())
    driver = cell.driver()
    state = driver.setup(run)
    driver.window(run, state)
    control = driver.check(run, state, control=True)
    assert run.correct, run.compared
    assert _fails(run, control), control
