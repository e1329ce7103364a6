"""The plain reference against the program's CPU path, float64, on a tiny
cube room and a tiny trajectory: the same LM costs step by step."""

import pytest
import torch

from benchmark.harness import loops, scenes
from benchmark.reference import lm_ba
from benchmark.solvers import banded, common, flat_sm

CPU = torch.device("cpu")
F64 = torch.float64
SMALL = {"rot": 0.002, "trans": 0.01, "point": 0.01}


def _setup(scene):
    fixed = scenes.fixed_mask(scene.n_cams, "first_last")
    inputs = common.program_inputs(*scenes.padded(scene), scene.n_cams,
                                   scene.n_points, fixed, F64, CPU)
    return fixed, inputs, loops.truth(scene, fixed, CPU)


@pytest.mark.parametrize("name", ["cube", "trajectory"])
def test_lm_costs_match_the_program(name):
    if name == "cube":
        scene = scenes.make_scene({"kind": "cube_room", "n_per_wall": 30,
                                   "n_cams": 12, "seed": 0})
        adapter = flat_sm
        levels = {"rot": 0.05, "trans": 0.1, "point": 0.1}
    else:
        scene = scenes.make_scene({"kind": "circle_trajectory", "n_cams": 48,
                                   "n_points": 1500, "track_len": 4.3368,
                                   "radius": 3.0, "seed": 11})
        adapter = banded
        levels = SMALL
    fixed, inputs, tr = _setup(scene)
    ctx = adapter.setup(inputs, {"lambda_init": 1e-4})
    P = lm_ba.problem(scene.cam, scene.lm, scene.uv, scene.w, scene.n_cams,
                      scene.n_points, fixed, F64, CPU)
    for i in range(2):
        start = scenes.perturbed_start(tr.R, tr.t, tr.X, tr.fixed, levels,
                                       scenes.stream_seed(5, 1, i))
        out = adapter.solve(ctx, *start, 4)
        ref = lm_ba.solve(*start, P, 4)
        prog = [float(c) for c in out.costs]
        assert len(prog) == len(ref.costs) == 5
        for p, r in zip(prog, ref.costs):
            assert abs(p - r) <= 1e-8 * ref.costs[0], (prog, ref.costs)
        assert float(lm_ba.cost(out.R, out.t, out.X, P)) == pytest.approx(
            prog[-1], rel=1e-6, abs=1e-14)
