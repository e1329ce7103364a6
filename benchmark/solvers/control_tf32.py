"""The control: the plain reference put in the program's place, computed in
float32 with TF32 on, the nearest precision below the configurations'
(float32, TF32 off). A run that drives it must come out not correct."""

import torch

from benchmark.reference import lm_ba
from benchmark.solvers import common

KIND = "closed_solves"
SPANS = {}


def _tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def setup(inputs, config, scene, fixed):
    """The reference's own layout, float32, on the program's device."""
    return {"config": config,
            "P": lm_ba.problem(scene.cam, scene.lm, scene.uv, scene.w,
                               scene.n_cams, scene.n_points, fixed,
                               torch.float32, inputs.fixed.device)}


def solve(ctx, R0, t0, X0, iters):
    _tf32()
    out = lm_ba.solve(R0, t0, X0, ctx["P"], iters,
                      lambda_init=ctx["config"]["lambda_init"])
    costs = [torch.tensor(c) for c in out.costs]
    return common.Solved(out.R, out.t, out.X, costs[-1], out.it, costs)
