"""Incremental online smoothing demo (solvers/incremental.py), port of
``examples/incremental_demo.py``: cameras arrive in groups along a
trajectory; each arrival extends the stored super-block factor over the
affected tail instead of refactoring the whole history, then takes
tail-restricted GN steps. A periodic batch rebatch polishes the estimate.

Run: python -m slam_tricks_tpu_torch.examples.incremental_demo [--cpu]
(the CUDA device in float32 by default, --cpu the CPU in float64; the JAX
example defaults to the CPU in float64 and takes --tpu for float32 on its
default device).
"""

import argparse

import torch

from slam_tricks_tpu_torch.evaluation.metrics import ate_rmse
from slam_tricks_tpu_torch.examples import example_device
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.sim import make_trajectory_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import banded_flat, incremental
from slam_tricks_tpu_torch.utils.logging import get_logger


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64")
    return ap


def _pose(poses, c):
    return se3.SE3(poses.R[c], poses.t[c])


def run(args):
    """The stream and the two batch re-solves; returns the numbers it logs
    (the start's and each arrival's cost with its factor tail, the streamed,
    rebatched and from-scratch costs, both ATEs)."""
    dev = example_device(args.cpu)
    log = get_logger("incremental_demo")
    dtype = torch.float64 if args.cpu else torch.float32

    C, L = 64, 960
    scene = make_trajectory_scene(n_cams=C, n_points=L, track_len=4,
                                  seed=11, dtype=dtype, device=dev)
    # odometry-grade initial noise: a real frontend hands the smoother
    # locally-consistent inits (relative pose odometry, landmarks
    # triangulated from current estimates); the default perturbation is
    # a stress test for BATCH solvers, which take 20+ LM iterations —
    # far more than the few tail-restricted GN steps spent per arrival
    poses0, points0, fixed = perturb_scene(
        scene, pose_rot_noise=0.004, pose_trans_noise=0.02,
        point_noise=0.02, seed=12)
    bw = banded_flat.build_banded_work(scene.obs, C, L, dtype=dtype)

    def reinit_tail(state, a_prev, a_new):
        """Odometry-style init of the arriving segment: compose measured
        relative increments (what a real frontend provides — here the
        increments of the noisy initial trajectory) onto the current
        estimated head, instead of keeping globally-drifted absolute
        guesses. Inactive cameras have zero live observations, so moving
        them cannot touch any stored prefix band block."""
        R, t = state.poses.R.clone(), state.poses.t.clone()
        for c in range(a_prev, a_new):
            Z = se3.mul(_pose(poses0, c), se3.inv(_pose(poses0, c - 1)))
            Tc = se3.mul(Z, se3.SE3(R[c - 1], t[c - 1]))
            R[c], t[c] = Tc.R, Tc.t
        return state._replace(poses=se3.SE3(R, t))

    a0 = C // 4
    state, c_dirty = incremental.smoother_init(poses0, points0, bw,
                                               n_active=a0)
    out = {"init_cost": float(state.cost), "arrivals": []}
    log.info("init on %d cams: cost %.4e", a0, out["init_cost"])
    schedule = list(range(a0, C + 1, 8))
    for a_prev, a_new in zip(schedule[:-1], schedule[1:]):
        state = reinit_tail(state, a_prev, a_new)
        state, c_dirty = incremental.smoother_arrive(
            state, bw, a_prev=a_prev, a_new=a_new, c_dirty=c_dirty,
            gn_steps=4)
        out["arrivals"].append((a_new, float(state.cost), int(c_dirty)))
        log.info("arrive -> %3d cams: cost %.4e (factor tail from cam %d)",
                 *out["arrivals"][-1])

    pts = incremental.scatter_points(state.points_s, bw, L)
    warm = banded_flat.solve_ba_banded(state.poses, pts, bw, max_iters=20)
    batch = banded_flat.solve_ba_banded(poses0, points0, bw, max_iters=20)
    out.update(stream_cost=float(state.cost),
               stream_ate=float(ate_rmse(state.poses, scene.poses_true)),
               warm_cost=float(warm.cost),
               warm_ate=float(ate_rmse(warm.poses, scene.poses_true)),
               batch_cost=float(batch.cost))
    log.info("streamed  cost %.4e | ATE %.4f", out["stream_cost"],
             out["stream_ate"])
    log.info("rebatched cost %.4e | ATE %.4f (batch-from-scratch %.4e)",
             out["warm_cost"], out["warm_ate"], out["batch_cost"])
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
