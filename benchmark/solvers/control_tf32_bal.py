"""The control of the BAL configurations: the plain reference
(``reference/lm_bal.py``) put in the program's place, computed in float32
with TF32 on, the nearest precision below the configurations' (float32,
TF32 off). A run that drives it must come out not correct."""

import torch

from benchmark.reference import lm_bal
from benchmark.solvers import control_tf32
from benchmark.solvers.bal import Solved

KIND = "closed_solves_bal"
SPANS = {}


def setup(inputs, config, scene, fixed):
    """The reference's own layout, float32, on the program's device."""
    return {"config": config,
            "P": lm_bal.problem(scene.cam, scene.lm, scene.uv, scene.w,
                                scene.n_cams, scene.n_points, fixed,
                                torch.float32, inputs.fixed.device)}


def solve(ctx, R0, t0, K0, X0, iters):
    control_tf32._tf32()
    out = lm_bal.solve(R0, t0, K0, X0, ctx["P"], iters,
                       lambda_init=ctx["config"]["lambda_init"])
    costs = [torch.tensor(c) for c in out.costs]
    return Solved(out.R, out.t, out.K, out.X, costs[-1], out.it, costs)
