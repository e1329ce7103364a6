"""The program's own spans (``utils.timer.annotate``) in the LM loop,
the two Schur solve steps and the layout builders, on toy scenes on the
CPU: under ``torch.profiler`` the exported Chrome trace holds one
``slam:lm.iter`` span an LM iteration, each of the shape that
``schur.lm_loop``'s docstring gives; with no profiler running a solve
enters no ``record_function``; and a profiler changes no output bit."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tests.torch_util  # noqa: F401  (caps torch's threads)
from slam_tricks_tpu_torch.sim import (make_scene, make_trajectory_scene,
                                       perturb_scene)
from slam_tricks_tpu_torch.solvers import banded_flat, schur_flat_sm
from slam_tricks_tpu_torch.utils import timer

ITER_CHILDREN = ("slam:lm.solve", "slam:lm.retract", "slam:lm.linearize",
                 "slam:lm.accept", "slam:sync.stop")
SOLVE_CHILDREN = ("slam:rcs", "slam:linear_solve", "slam:backsub")
LAYOUT_CHILDREN = ("slam:layout.track_table", "slam:layout.upload",
                   "slam:layout.tables")
ITERS = 4


def _scene(name):
    if name == "flat_sm":
        sc = make_scene(n_per_wall=12, n_cams=8, seed=5,
                        dtype=torch.float64, device="cpu")
    else:
        sc = make_trajectory_scene(n_cams=12, n_points=120, track_len=4,
                                   seed=7, dtype=torch.float64, device="cpu")
    return sc, perturb_scene(sc, pose_rot_noise=0.01, pose_trans_noise=0.02,
                             point_noise=0.02, seed=6)


def _build(name, sc):
    if name == "flat_sm":
        return schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                             dtype=torch.float64)
    return banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                         dtype=torch.float64)


def _solve(name, work, start):
    poses0, points0, fixed = start
    fn = (schur_flat_sm.solve_ba_flat_sm if name == "flat_sm"
          else banded_flat.solve_ba_banded)
    return fn(poses0, points0, work, fixed_mask=fixed, max_iters=ITERS)


def _spans(prof, tmp_path):
    """The trace's slam:* host spans as (name, start, end), and each one's
    parent: the shortest other slam:* span that holds it, or None."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("slam:")]
    parent = []
    for i, (_, a, b) in enumerate(spans):
        around = [(b2 - a2, j) for j, (_, a2, b2) in enumerate(spans)
                  if j != i and a2 <= a and b <= b2]
        parent.append(min(around)[1] if around else None)
    return spans, parent


def _children(spans, parent, i):
    return sorted(spans[j][0] for j, p in enumerate(parent) if p == i)


def test_annotate_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = timer.annotate("slam:a"), timer.annotate("slam:b")
    assert a is b
    with a, b:      # reentrant
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(timer.annotate("slam:a"),
                          torch.profiler.record_function)


@pytest.mark.parametrize("name", ["flat_sm", "banded"])
def test_span_tree_of_a_solve(name, tmp_path):
    sc, start = _scene(name)
    work = _build(name, sc)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _solve(name, work, start)
    spans, parent = _spans(prof, tmp_path)
    names = [s[0] for s in spans]
    iters = [i for i, n in enumerate(names) if n == "slam:lm.iter"]
    assert 1 <= out.it == len(iters)
    for i in iters:
        assert parent[i] is None
        assert _children(spans, parent, i) == sorted(ITER_CHILDREN)
    solves = [i for i, n in enumerate(names) if n == "slam:lm.solve"]
    assert len(solves) == out.it
    for i in solves:
        assert _children(spans, parent, i) == sorted(SOLVE_CHILDREN)
    # the first linearization, before the loop, holds no iteration
    lin = [i for i, n in enumerate(names) if n == "slam:lm.linearize"]
    assert len(lin) == out.it + 1
    assert sum(parent[i] is None for i in lin) == 1
    assert len(spans) == 1 + out.it * (1 + len(ITER_CHILDREN)
                                       + len(SOLVE_CHILDREN))


@pytest.mark.parametrize("name", ["flat_sm", "banded"])
def test_layout_builder_spans(name, tmp_path):
    sc, _ = _scene(name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _build(name, sc)
    spans, parent = _spans(prof, tmp_path)
    top = [i for i, p in enumerate(parent) if p is None]
    assert [spans[i][0] for i in top] == [
        "slam:layout.slot_work" if name == "flat_sm"
        else "slam:layout.banded_work"]
    # the slot layout builds its track table, then lays the slots out
    extra = ["slam:layout.track_table"] if name == "flat_sm" else []
    assert _children(spans, parent, top[0]) == sorted(
        list(LAYOUT_CHILDREN) + extra)


@pytest.mark.parametrize("name", ["flat_sm", "banded"])
def test_no_profiler_no_record_function_and_the_same_bits(name,
                                                          monkeypatch):
    sc, start = _scene(name)
    work = _build(name, sc)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _solve(name, work, start)

    opened = []

    class Counting(torch.profiler.record_function):
        def __init__(self, *args, **kwargs):
            opened.append(args)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    plain = _solve(name, work, start)
    assert opened == []
    assert traced.it == plain.it >= 1 and traced.done == plain.done
    for a, b in ((traced.poses.R, plain.poses.R),
                 (traced.poses.t, plain.poses.t),
                 (traced.points, plain.points), (traced.cost, plain.cost),
                 (traced.lam, plain.lam)):
        assert torch.equal(a, b)
