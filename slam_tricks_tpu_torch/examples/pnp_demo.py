"""PnP solver comparison — the st17 main analog (4-way comparison,
st17-ceres/src/main.cpp:48-127), port of ``examples/pnp_demo.py``: generic
autodiff LM vs analytic-Jacobian GN vs batched solves, with timing.

Run:  python -m slam_tricks_tpu_torch.examples.pnp_demo [--cpu]
"""

import argparse

import numpy as np
import torch

from slam_tricks_tpu_torch.examples import example_device
from slam_tricks_tpu_torch.manifolds import lie, se3, so3_r3
from slam_tricks_tpu_torch.residuals import reprojection
from slam_tricks_tpu_torch.solvers import gauss_newton, levenberg_marquardt
from slam_tricks_tpu_torch.solvers.pnp import solve_pnp, solve_pnp_batched
from slam_tricks_tpu_torch.utils import get_logger, time_fn


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64")
    ap.add_argument("--n-obs", type=int, default=20)
    return ap


def run(args):
    """The four solves; returns the numbers it logs (each solve's best time
    in ms, cost and, for LM, iterations; the batch's largest cost) and the
    largest pose error against the truth of the single solves and of the
    batch (max |R - R_true|, |t - t_true|)."""
    dev = example_device(args.cpu)
    log = get_logger("pnp_demo")
    dtype = np.float64 if args.cpu else np.float32
    rng = np.random.default_rng(0)

    def T_(a):
        return torch.as_tensor(a.astype(dtype), device=dev)

    pts = T_(rng.uniform([-2, -2, 4], [2, 2, 8], (args.n_obs, 3)))
    T_true = se3.exp(T_(rng.normal(size=6) * 0.3))
    pc = se3.act(T_true, pts)
    uv = pc[:, :2] / pc[:, 2:]
    T0 = se3.retract(T_true, T_(rng.normal(size=6) * 0.1))

    def pnp_res(T, p, o):
        return reprojection.reproject_normalized(T, p, o)

    def pose_err(T, T_ref):
        return max(float((T.R - T_ref.R).abs().max()),
                   float((T.t - T_ref.t).abs().max()))

    out = {}
    # 1) autodiff LM with SE(3) exp parameterization (DynamicAutoDiff analog)
    dt, r1 = time_fn(lambda T: levenberg_marquardt(
        pnp_res, T, lie(se3), args=(pts, uv), max_iters=40), T0)
    out.update(lm_ms=dt * 1e3, lm_cost=float(r1.cost),
               lm_iters=int(r1.iterations))
    log.info("LM + jacfwd + SE3 exp:      %.4f ms  cost %.3e  iters %d",
             out["lm_ms"], out["lm_cost"], out["lm_iters"])

    # 2) autodiff GN with SO3(+)R3 (g2o-vertex parameterization)
    dt, r2 = time_fn(lambda T: gauss_newton(
        pnp_res, T, so3_r3(), args=(pts, uv), iters=10), T0)
    out.update(gn_ms=dt * 1e3, gn_cost=float(r2.cost))
    log.info("GN + jacfwd + SO3+R3:       %.4f ms  cost %.3e", out["gn_ms"],
             out["gn_cost"])

    # 3) analytic-Jacobian GN (SelfGaussNewton analog — reference: 0.0192 ms)
    dt, r3 = time_fn(lambda T: solve_pnp(T0, pts, uv, iters=10), T0)
    out.update(analytic_ms=dt * 1e3, analytic_cost=float(r3.cost))
    log.info("GN analytic J:              %.4f ms  cost %.3e",
             out["analytic_ms"], out["analytic_cost"])

    # 4) 8192 problems batched (what no single-core solver can do)
    B = 8192
    ptsb = T_(rng.uniform([-2, -2, 4], [2, 2, 8], (B, 32, 3)))
    Tt = se3.exp(T_(rng.normal(size=(B, 6)) * 0.2))
    pcb = se3.act(se3.SE3(Tt.R[:, None], Tt.t[:, None]), ptsb)
    uvb = pcb[..., :2] / pcb[..., 2:]
    T0b = se3.retract(Tt, T_(rng.normal(size=(B, 6)) * 0.05))
    dt, r4 = time_fn(solve_pnp_batched, T0b, ptsb, uvb)
    out.update(batch=B, batch_ms=dt * 1e3, batch_ms_per_solve=dt / B * 1e3,
               batch_max_cost=float(r4.cost.max()),
               pose_err=max(pose_err(r1.x, T_true), pose_err(r2.x, T_true),
                            pose_err(r3.T, T_true)),
               batch_pose_err=pose_err(r4.T, Tt))
    log.info("batched x%d analytic GN:  %.1f ms total -> %.4f ms/solve, max "
             "cost %.2e", B, out["batch_ms"], out["batch_ms_per_solve"],
             out["batch_max_cost"])
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
