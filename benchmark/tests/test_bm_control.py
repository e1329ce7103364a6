"""The control on the card: the plain reference, computed in float32 with
TF32, in the program's place must come out not correct, with the sound
program beside it correct on the same seed. Each cell at its own size, a
short window (the cells are small enough for a test run: under 2 GB)."""

import time

import pytest
import torch

from benchmark.harness import manifest, runner

CELLS = ["st20-solve", "ladybug-solve"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(require_cuda, workload):
    device = torch.device("cuda", 0)
    cell = manifest.Cell(workload)
    res = {}
    for control in (False, True):
        res[control] = runner.run_cell(
            workload, 2 ** 31 + 101, 2.0, False, device,
            time.perf_counter(), control=control, cell=cell,
            log=lambda msg: None)
    assert res[False]["correct"], res[False]["checks"]
    assert not res[True]["correct"], res[True]["checks"]
