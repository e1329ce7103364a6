"""BAL's batch solve: ``schur_bal.solve_bal``, LM with 9-parameter cameras
on the bucketed slot layout, the reduced camera system summed over
within-track pairs, and the dense solve."""

from typing import NamedTuple

import torch

from benchmark.solvers import common

KIND = "closed_solves_bal"
MODULE = "slam_tricks_tpu_torch.solvers.schur_bal"

# layer -> the names in the solver's module that the layer's span wraps
SPANS = {
    "assemble": [(MODULE, "linearize_assemble_grids")],
    "rcs": [(MODULE, "reduced_camera_system")],
    "spd_solve": [(MODULE, "spd_solve")],
}


class Solved(NamedTuple):
    R: torch.Tensor           # (C, 3, 3)
    t: torch.Tensor           # (C, 3)
    K: torch.Tensor           # (C, 3) [f, k1, k2]
    X: torch.Tensor           # (L, 3), landmark order
    cost: torch.Tensor        # device scalar
    it: int                   # LM iterations taken
    costs: list               # device scalars: the start, then each step


def setup(inputs, config, scene=None, fixed=None):
    from slam_tricks_tpu_torch.solvers import schur_bal
    work = schur_bal.build_bal_work(inputs.obs, inputs.n_cams,
                                    inputs.n_points, dtype=inputs.dtype)
    return {"work": work, "inputs": inputs, "config": config}


def solve(ctx, R0, t0, K0, X0, iters):
    from slam_tricks_tpu_torch.solvers import schur_bal
    costs = []
    out = schur_bal.solve_bal(
        common.se3(R0, t0), K0, X0, ctx["work"],
        fixed_mask=ctx["inputs"].fixed, max_iters=iters,
        lambda_init=ctx["config"]["lambda_init"], costs=costs)
    return Solved(out.poses.R, out.poses.t, out.poses.intr, out.points,
                  out.cost, out.it, costs)
