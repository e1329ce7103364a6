"""Scale-drift-aware mono loop closing demo (manifolds/sim3.py +
solvers/posegraph_sim3.py), port of ``examples/sim3_posegraph_demo.py``: a
monocular odometry chain around a circle accumulates multiplicative scale
drift; loop-closure similarity measurements expose the accumulated scale
ratio, and Sim(3) pose-graph optimization recovers the metric trajectory AND
the latent per-keyframe scale profile — which SE(3) optimization on the
identical graph structurally cannot (Strasdat et al., RSS 2010).

Run: python -m slam_tricks_tpu_torch.examples.sim3_posegraph_demo [--cpu]
(the CUDA device in float32 by default, --cpu the CPU in float64; the JAX
example defaults to the CPU in float64 and takes --tpu for float32 on its
default device).
"""

import argparse

import numpy as np
import torch

from slam_tricks_tpu_torch.examples import example_device
from slam_tricks_tpu_torch.manifolds import se3, sim3
from slam_tricks_tpu_torch.solvers import (solve_pose_graph,
                                           solve_pose_graph_sim3)
from slam_tricks_tpu_torch.solvers.common import tree_map
from slam_tricks_tpu_torch.utils.logging import get_logger


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64")
    return ap


def run(args):
    """Simulate the drifted loop and solve it in Sim(3) and in SE(3);
    returns the numbers it logs (the drifted map's ATE and stretch, each
    solve's ATE, the Sim(3) solve's scale error, cost and iterations)."""
    dev = example_device(args.cpu)
    log = get_logger("sim3_demo")
    dtype = np.float64 if args.cpu else np.float32

    def T_(a):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=dev)

    # ---- simulate a mono keyframe loop with scale drift -------------------
    N, n_loops, ds = 96, 6, 0.004
    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(N) / N
    t_true = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                       0.1 * np.sin(3 * ang)], 1)
    Rt = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                             [np.sin(a), np.cos(a), 0],
                             [0, 0, 1]]) for a in ang])
    p = np.exp(-ds * np.arange(N))  # latent local map scale per keyframe
    gt = sim3.Sim3(T_(Rt), T_(t_true), T_(p))

    ii = np.concatenate([np.arange(N - 1), rng.integers(0, N // 4, n_loops)])
    jj = np.concatenate([np.arange(1, N),
                         rng.integers(3 * N // 4, N, n_loops)])
    Si = tree_map(lambda a: a[ii], gt)
    Sj = tree_map(lambda a: a[jj], gt)
    Zc = sim3.mul(sim3.inv(Si), Sj)
    xi = rng.normal(size=(len(ii), 7)) * 1e-3
    xi[N - 1:] = 0.0  # loop-closure measurements exact
    Z = sim3.mul(Zc, sim3.exp(T_(xi)))
    info = np.broadcast_to(np.eye(7, dtype=dtype), (len(ii), 7, 7)).copy()
    info[N - 1:] *= 10.0

    # uncorrected mono map: integrate (R, t) with no scale compensation
    Rz = Z.R.cpu().numpy().astype(np.float64)
    tz = Z.t.cpu().numpy().astype(np.float64)
    R0, t0 = [Rt[0]], [t_true[0]]
    for k in range(N - 1):
        t0.append(R0[-1] @ tz[k] + t0[-1])
        R0.append(R0[-1] @ Rz[k])
    poses0 = sim3.Sim3(T_(np.stack(R0)), T_(np.stack(t0)),
                       torch.ones(N, dtype=gt.s.dtype, device=dev))

    def ate(t_est):
        return float(np.sqrt(np.mean(np.sum(
            (t_est.cpu().numpy().astype(np.float64) - t_true) ** 2, 1))))

    out = {"drift_ate": ate(poses0.t), "drift_stretch": float(1 / p[-1])}
    log.info("drifted mono map ATE: %.3f m (scale stretched up to %.2fx)",
             out["drift_ate"], out["drift_stretch"])

    # ---- Sim(3) vs SE(3) on the identical graph ---------------------------
    i_t = torch.as_tensor(ii, device=dev)
    j_t = torch.as_tensor(jj, device=dev)
    out7 = solve_pose_graph_sim3(poses0, i_t, j_t, Z, T_(info), max_iters=50)
    out6 = solve_pose_graph(se3.SE3(poses0.R, poses0.t), i_t, j_t,
                            se3.SE3(Z.R, Z.t), T_(info[:, :6, :6]),
                            max_iters=50)
    s_err = np.abs(out7.poses.s.cpu().numpy().astype(np.float64) / p
                   - 1.0).max()
    out.update(sim3_ate=ate(out7.poses.t), scale_err=float(s_err),
               sim3_cost=float(out7.cost), sim3_iters=int(out7.it),
               se3_ate=ate(out6.poses.t), se3_cost=float(out6.cost),
               se3_iters=int(out6.it))
    log.info("Sim(3) PGO: ATE %.4f m, latent scale profile recovered to "
             "%.2f%% (cost %.3e, %d iters)", out["sim3_ate"],
             100 * out["scale_err"], out["sim3_cost"], out["sim3_iters"])
    log.info("SE(3) PGO on the same data: ATE %.4f m — scale is not in its "
             "state, so the drift-stretched odometry and the exact loops "
             "can only be compromised, not reconciled", out["se3_ate"])
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
