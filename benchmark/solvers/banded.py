"""The trajectory's batch solve: ``banded_flat.solve_ba_banded``, LM on
the slot-major banded layout with the block-tridiagonal solve."""

from benchmark.solvers import common

KIND = "closed_solves"
MODULE = "slam_tricks_tpu_torch.solvers.banded_flat"

SPANS = {
    "assemble": [(MODULE, "linearize_assemble")],
    "rcs": [(MODULE, "reduced_camera_system")],
    "tridiag": [(MODULE, "tridiag_solve")],
}


def setup(inputs, config, scene=None, fixed=None):
    from slam_tricks_tpu_torch.solvers import banded_flat
    bw = banded_flat.build_banded_work(inputs.obs, inputs.n_cams,
                                       inputs.n_points, dtype=inputs.dtype)
    return {"bw": bw, "inputs": inputs, "config": config}


def solve(ctx, R0, t0, X0, iters):
    from slam_tricks_tpu_torch.solvers import banded_flat
    costs = []
    out = banded_flat.solve_ba_banded(
        common.se3(R0, t0), X0, ctx["bw"], fixed_mask=ctx["inputs"].fixed,
        max_iters=iters, lambda_init=ctx["config"]["lambda_init"],
        costs=costs)
    return common.Solved(out.poses.R, out.poses.t, out.points, out.cost,
                         out.it, costs)
