"""Visual-inertial smoothing demo — the application of st23's preintegration
theory (st23-lie-group-v2/doc.tex:132-1148, theory-only in the reference);
port of ``examples/vi_smoother_demo.py``.

Simulates an analytic trajectory with a noisy IMU stream and noisy keyframe
pose observations, preintegrates every segment in one batch, and runs three
estimators:

  1. dead-reckoning (raw integration at a wrong bias guess)   -> diverges
  2. the dense VI MAP smoother (poses+velocities+shared bias) -> beats the
     raw observations and recovers the bias
  3. visual-inertial BA from a 0.7x-mis-scaled initialization -> recovers
     METRIC SCALE (a monocular BA keeps the wrong scale forever: scale is a
     gauge freedom of reprojection, broken only by the accelerometer)

float32 on the CUDA device and with --cpu alike, as the JAX example.

Run:  python -m slam_tricks_tpu_torch.examples.vi_smoother_demo [--cpu]
"""

import argparse

import numpy as np
import torch

from slam_tricks_tpu_torch.estimation import vi_smoother as vis
from slam_tricks_tpu_torch.estimation.vi_init import vi_initialize
from slam_tricks_tpu_torch.evaluation.metrics import ate_translation_rmse
from slam_tricks_tpu_torch.examples import example_device
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.solvers.common import tree_map


def t_rmse(poses_a, poses_b):
    return float(ate_translation_rmse(poses_a, poses_b))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--keyframes", type=int, default=20)
    return ap


def run(args):
    """The three estimators and the closed-form bootstrap; returns the
    numbers it prints (ATEs, LM iterations, bias errors, recovered scales,
    gravity)."""
    dev = example_device(args.cpu)
    dtype = torch.float32
    sim = vis.simulate_vi(n_keyframes=args.keyframes, samples_per_seg=100,
                          dt=0.005, sigma_g=2e-4, sigma_a=2e-3,
                          obs_rot_noise=0.005, obs_trans_noise=0.01,
                          seed=3, dtype=dtype, device=dev)
    bias0 = torch.zeros(6, dtype=dtype, device=dev)  # wrong: true bias != 0
    pre = vis.preintegrate_segments(sim, bias0[:3], bias0[3:],
                                    sigma_g=2e-4, sigma_a=2e-3)

    T0 = tree_map(lambda a: a[0], sim.obs_poses)
    poses_dr, vels_dr = vis.dead_reckon(pre, T0, sim.vels_true[0],
                                        bias0[:3], bias0[3:])
    out = {"dead_reckoning_ate": t_rmse(poses_dr, sim.poses_true),
           "observation_ate": t_rmse(sim.obs_poses, sim.poses_true)}
    print(f"dead-reckoning ATE (wrong bias): "
          f"{out['dead_reckoning_ate']:.4f} m")
    print(f"raw pose-observation ATE:        "
          f"{out['observation_ate']:.4f} m")

    sol = vis.solve_vi_smoother(pre, sim.obs_poses, poses_dr, vels_dr, bias0,
                                obs_rot_sigma=0.005, obs_trans_sigma=0.01)
    bias_true = np.concatenate([sim.bg_true.cpu().numpy(),
                                sim.ba_true.cpu().numpy()])
    out.update(smoother_ate=t_rmse(sol.poses, sim.poses_true),
               smoother_iters=int(sol.iterations),
               bias_err0=float(np.linalg.norm(bias_true)),
               bias_err=float(np.linalg.norm(sol.bias.cpu().numpy()
                                             - bias_true)))
    print(f"VI smoother ATE:                 "
          f"{out['smoother_ate']:.4f} m  "
          f"({out['smoother_iters']} LM iters)")
    print(f"bias error: {out['bias_err0']:.4f} -> {out['bias_err']:.4f}")

    # --- metric-scale recovery with visual landmarks ---
    points, uv, w = vis.simulate_vi_landmarks(sim, n_landmarks=80,
                                              uv_noise=5e-4, seed=2)
    s0 = 0.7
    c = sim.poses_true.t[0]
    poses_scaled = se3.SE3(sim.poses_true.R, c + s0 * (sim.poses_true.t - c))
    solba, pts = vis.solve_vi_ba(pre, uv, w, poses_scaled,
                                 s0 * sim.vels_true, bias0,
                                 c + s0 * (points - c),
                                 pose0_prior=tree_map(lambda a: a[0],
                                                      sim.poses_true))
    d_est = np.linalg.norm(np.diff(solba.poses.t.cpu().numpy(), axis=0),
                           axis=1)
    d_true = np.linalg.norm(np.diff(sim.poses_true.t.cpu().numpy(), axis=0),
                            axis=1)
    out["vi_ba_scale"] = float((d_est / d_true).mean())
    print(f"VI-BA: scale initialized at {s0:.2f}x -> recovered "
          f"{out['vi_ba_scale']:.3f}x metric")

    # --- closed-form bootstrap (no optimization at all) ---
    init = vi_initialize(pre, poses_scaled)
    g = init.gravity.cpu().numpy()
    out.update(vi_init_scale=float(init.scale) * s0,
               gravity=[float(v) for v in g])
    print(f"vi_initialize (one lstsq): scale {out['vi_init_scale']:.3f}x, "
          f"gravity [{g[0]:.2f} {g[1]:.2f} {g[2]:.2f}]")
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
