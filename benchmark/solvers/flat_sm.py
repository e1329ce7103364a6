"""The headline solve: ``schur_flat_sm.solve_ba_flat_sm``, the slot-major
dense Schur LM of the st20 cube room."""

from benchmark.solvers import common

KIND = "closed_solves"
MODULE = "slam_tricks_tpu_torch.solvers.schur_flat_sm"

# layer -> the names in the solver's module that the layer's span wraps
SPANS = {
    "assemble": [(MODULE, "linearize_assemble")],
    "rcs": [(MODULE, "reduced_camera_system")],
    "spd_solve": [(MODULE, "spd_solve")],
}


def setup(inputs, config, scene=None, fixed=None):
    from slam_tricks_tpu_torch.solvers import schur_flat_sm
    work = schur_flat_sm.build_slot_work(inputs.obs, inputs.n_cams,
                                         inputs.n_points, dtype=inputs.dtype)
    return {"work": work, "inputs": inputs, "config": config}


def solve(ctx, R0, t0, X0, iters):
    from slam_tricks_tpu_torch.solvers import schur_flat_sm
    costs = []
    out = schur_flat_sm.solve_ba_flat_sm(
        common.se3(R0, t0), X0, ctx["work"], fixed_mask=ctx["inputs"].fixed,
        max_iters=iters, lambda_init=ctx["config"]["lambda_init"],
        costs=costs)
    return common.Solved(out.poses.R, out.poses.t, out.points, out.cost,
                         out.it, costs)
