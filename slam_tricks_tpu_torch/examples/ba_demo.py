"""Bundle-adjustment demo — the st20 test_ceres/test_g2o main analog (port of
``examples/ba_demo.py``).

Simulates the cube-room scene, perturbs, solves with the Schur LM solver,
reports cost/ATE, streams per-iteration metrics (IterationCallback role), and
renders the Hessian sparsity + scene (DataManager viz roles; needs
matplotlib).

Run:  python -m slam_tricks_tpu_torch.examples.ba_demo [--cpu]
"""

import argparse
import os
import tempfile

import torch

from slam_tricks_tpu_torch.evaluation.metrics import (ate_translation_rmse,
                                                      reprojection_rms)
from slam_tricks_tpu_torch.examples import example_device
from slam_tricks_tpu_torch.sim import make_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import schur
from slam_tricks_tpu_torch.utils import Timer, get_logger
from slam_tricks_tpu_torch.viz import hessian_sparsity_image, plot_ba_scene


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64")
    ap.add_argument("--cams", type=int, default=30)
    ap.add_argument("--per-wall", type=int, default=100)
    ap.add_argument("--noise", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "ba_demo"))
    return ap


def run(args):
    """The solve: returns the scene, the final BAState and the numbers it
    logs (observations, initial and final ATE, the per-iteration costs of
    the first solve, final cost, iterations, reprojection RMS, both laps in
    seconds)."""
    dev = example_device(args.cpu)
    log = get_logger("ba_demo")
    dtype = torch.float64 if args.cpu else torch.float32
    scene = make_scene(n_per_wall=args.per_wall, n_cams=args.cams,
                       pix_noise=args.noise, dtype=dtype, device=dev)
    poses0, points0, fixed = perturb_scene(scene)
    n_obs = int((scene.obs.weight > 0).sum())
    log.info("scene: %d cams, %d landmarks, %d observations",
             scene.n_cams, scene.n_points, n_obs)
    ate0 = float(ate_translation_rmse(poses0, scene.poses_true))
    log.info("initial ATE: %.4f m", ate0)

    costs = []

    def iter_cb(it, cost, lam):
        costs.append(float(cost))
        log.process("iter %3d  cost %.6e  lambda %.2e", int(it), float(cost),
                    float(lam))

    t = Timer()
    final = schur.solve_ba(poses0, points0, scene.obs, fixed_mask=fixed,
                           max_iters=30, callback=iter_cb)
    first_s = t.lap("first solve", sync=final)
    final = schur.solve_ba(poses0, points0, scene.obs, fixed_mask=fixed,
                           max_iters=30)
    second_s = t.lap("second solve", sync=final)
    log.info(t.report())

    log.info("final cost %.4e in %d iters", float(final.cost), int(final.it))
    ate = float(ate_translation_rmse(final.poses, scene.poses_true))
    rms = float(reprojection_rms(final.poses, final.points, scene.obs.cam_idx,
                                 scene.obs.lm_idx, scene.obs.uv,
                                 scene.obs.weight))
    log.info("final ATE: %.6f m | reprojection RMS: %.3e", ate, rms)
    return {"scene": scene, "state": final, "n_obs": n_obs,
            "initial_ate": ate0, "costs": costs,
            "final_cost": float(final.cost), "iters": int(final.it),
            "final_ate": ate, "reprojection_rms": rms,
            "first_solve_s": first_s, "second_solve_s": second_s}


def write_images(out_dir, scene, final):
    """The Hessian sparsity image and the scene plot (matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    img = hessian_sparsity_image(scene.n_cams, min(scene.n_points, 120),
                                 scene.obs.cam_idx,
                                 scene.obs.lm_idx.cpu().numpy() % 120)
    paths = (os.path.join(out_dir, "hessian_sparsity.png"),
             os.path.join(out_dir, "scene.png"))
    plt.imsave(paths[0], img, cmap="gray")
    plot_ba_scene(paths[1], final.poses, final.points)
    get_logger("ba_demo").info("wrote %s/{hessian_sparsity.png, scene.png}",
                               out_dir)
    return paths


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(args)
    out["images"] = write_images(args.out, out["scene"], out["state"])
    return out


if __name__ == "__main__":
    main()
