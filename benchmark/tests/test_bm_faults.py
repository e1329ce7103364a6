"""A run with the timed path broken underneath comes out not correct.

Each case drives ``runner.run_cell`` (all of a run but run.py's look for a
card) on the CPU at a toy size in float64, with the limits the sound run
passes, and breaks the program in one of the ways a cell can fail: a step
that returns its state unchanged, the state frozen at or after the last
step that the step costs compare, half of the observations left out of the
linearization, an answer altered where it is produced. (The cells run on one card: no exchange between
chips to leave out.)"""

import time

import pytest
import torch

from benchmark.harness import manifest, runner

CPU = torch.device("cpu")


def _cell(workload):
    """The cell at a toy size in float64; the step costs compare one step,
    so that a state frozen after the second is not yet at the float64
    floor."""
    cell = manifest.Cell(workload)
    cell.config = dict(cell.config, dtype="float64")
    scene = cell.config["scene"]
    if workload == "st20-solve":
        cell.config["scene"] = dict(scene, n_per_wall=30, n_cams=12)
        cell.traffic = dict(cell.traffic, lm_iters=8)
    else:
        cell.config["scene"] = dict(scene, n_cams=48, n_points=1500,
                                    radius=3.0)
        cell.traffic = dict(cell.traffic, lm_iters=6)
    cell.traffic["check"] = {"count": 4, "steps": 1}
    return cell


# what the sound toy runs pass (float64) and every fault fails
LIMITS = {"step_cost_gap": 1e-6, "final_cost": 1e-12}


def _run(workload):
    return runner.run_cell(workload, 2 ** 31 + 7, 1.0, False, CPU,
                           time.perf_counter(), limits=LIMITS,
                           cell=_cell(workload), log=lambda msg: None)


def _unchanged(monkeypatch, workload):
    from slam_tricks_tpu_torch.solvers import schur
    monkeypatch.setattr(schur, "_retract_state",
                        lambda poses, points, dp, dl: (poses, points))


def _half(monkeypatch, workload):
    from slam_tricks_tpu_torch.solvers import banded_flat, schur_flat_sm
    mod = schur_flat_sm if workload == "st20-solve" else banded_flat
    real = mod.linearize_assemble

    def half(R, t, X, uv0, uv1, w, cam, index, loss=None):
        w = w.clone()
        w[:, w.shape[1] // 2:] = 0
        return real(R, t, X, uv0, uv1, w, cam, None, loss)
    monkeypatch.setattr(mod, "linearize_assemble", half)


def _altered(monkeypatch, workload):
    from benchmark.solvers import banded, flat_sm
    mod = flat_sm if workload == "st20-solve" else banded
    real = mod.solve
    monkeypatch.setattr(mod, "solve", lambda *a: real(*a)._replace(
        X=real(*a).X + 1e-2))


def _frozen(fault):
    def plant(monkeypatch, workload):
        """The traffic kind's fault, as calibration reads it, planted in the
        cell's adapter."""
        cell = _cell(workload)
        adapter = cell.adapter()
        broken = cell.kind.FAULTS[fault](adapter, cell.traffic)
        monkeypatch.setattr(adapter, "solve", broken.solve)
    plant.__name__ = fault
    return plant


WORKLOADS = ["st20-solve", "ladybug-solve"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered,
                                   _frozen("frozen_at_check"),
                                   _frozen("frozen_after_check")])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_run_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    res = _run(workload)
    assert not res["correct"], res["checks"]
