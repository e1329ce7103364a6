"""Two-view reconstruction demo — the st22 main analog (port of
``examples/two_view_demo.py``): simulate, robust 8-point init, recover pose,
triangulate, joint refinement; report pose error and per-point depth errors
(main.cpp:17-36 logging role).

Run:  python -m slam_tricks_tpu_torch.examples.two_view_demo [--cpu]
"""

import argparse

import numpy as np
import torch

from slam_tricks_tpu_torch.examples import example_device
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.pipelines import solve_two_view
from slam_tricks_tpu_torch.sim.two_view import make_two_view
from slam_tricks_tpu_torch.utils import get_logger


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64")
    return ap


def run(args):
    """Solve the two-view scene; returns the numbers it logs (cheirality
    votes, rotation and translation-direction errors, depth errors, the
    refined cost)."""
    dev = example_device(args.cpu)
    log = get_logger("two_view_demo")
    dtype = torch.float64 if args.cpu else torch.float32
    scene = make_two_view(n_points=100, noise=3e-4, dtype=dtype, device=dev)
    res = solve_two_view(scene.uv1, scene.uv2)

    t_ref = scene.T_12.t.cpu().numpy()
    scale = np.linalg.norm(t_ref)
    t_ref_n = t_ref / scale
    rot_err = float(np.abs(res.T_12.R.cpu().numpy()
                           - scene.T_12.R.cpu().numpy()).max())
    t_err = float(np.abs(res.T_12.t.cpu().numpy() - t_ref_n).max())
    n_cheiral = int(res.n_cheiral)
    log.info("cheirality votes: %d/100", n_cheiral)
    log.info("rotation err (max abs): %.2e | translation dir err: %.2e",
             rot_err, t_err)

    # depth comparison in cam-1 frame (reference logs per-point depths)
    p_c1 = se3.act(scene.T1, scene.points).cpu().numpy() / scale
    depth_err = np.abs(res.points[:, 2].cpu().numpy() - p_c1[:, 2])
    out = {"n_cheiral": n_cheiral, "rot_err": rot_err, "t_err": t_err,
           "depth_err_median": float(np.median(depth_err)),
           "depth_err_max": float(depth_err.max()),
           "final_cost": float(res.final_cost)}
    log.info("depth err (scale-normalized): median %.2e max %.2e",
             out["depth_err_median"], out["depth_err_max"])
    log.info("refined cost: %.3e", out["final_cost"])
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
