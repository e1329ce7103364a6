"""Camera-calibration demo — the st3 main analog (port of
``examples/calibration_demo.py``). Uses the corner files of ``--calib-dir``
when given (the reference repo's st3-calibration/calib/*.txt: a 5x8 board
of 2.8 cm squares), else a synthetic scene of 9 views.

Run:  python -m slam_tricks_tpu_torch.examples.calibration_demo [--cpu]
      [--calib-dir DIR]
"""

import argparse
import glob
import os

import numpy as np
import torch

from slam_tricks_tpu_torch.examples import example_device
from slam_tricks_tpu_torch.pipelines.calibration import calibrate
from slam_tricks_tpu_torch.sim.calib_scene import make_calib_scene
from slam_tricks_tpu_torch.utils import get_logger
from slam_tricks_tpu_torch.utils.io import board_model_points, read_cbcorners


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in float64")
    ap.add_argument("--calib-dir", default=None,
                    help="a directory of corner files (*.txt) to calibrate "
                         "from, in place of the synthetic scene")
    return ap


def run(args):
    """Calibrate; returns the numbers it logs (RMS in px, LM iterations,
    the intrinsics and the distortion) and its dataset ("corners" or
    "synthetic")."""
    dev = example_device(args.cpu)
    dtype = torch.float64 if args.cpu else torch.float32
    log = get_logger("calib_demo")

    if args.calib_dir is not None:
        files = sorted(glob.glob(os.path.join(args.calib_dir, "*.txt")))
        if not files:
            raise FileNotFoundError(f"no corner files in {args.calib_dir}")
        views = []
        rows = cols = None
        for f in files:
            rows, cols, corners = read_cbcorners(f)
            views.append(corners)
        board = torch.as_tensor(board_model_points(rows, cols, 0.028),
                                dtype=dtype, device=dev)
        image_pts = torch.as_tensor(np.stack(views), dtype=dtype, device=dev)
        log.info("real dataset: %d views of a %dx%d board", len(files), rows,
                 cols)
    else:
        scene = make_calib_scene(n_views=9, noise=0.1, dtype=dtype,
                                 device=dev)
        board, image_pts = scene.board_pts, scene.image_pts
        log.info("synthetic dataset: 9 views")

    res = calibrate(board, image_pts, max_iters=80)
    out = {"dataset": "synthetic" if args.calib_dir is None else "corners",
           "rms_px": float(res.rms_px), "iterations": int(res.iterations),
           **{k: float(v) for k, v in res.intrinsics._asdict().items()},
           **{k: float(v) for k, v in res.distortion._asdict().items()}}
    log.info("reprojection RMS: %.4f px in %d LM iterations", out["rms_px"],
             out["iterations"])
    log.info("K: fx=%.2f fy=%.2f cx=%.2f cy=%.2f", out["fx"], out["fy"],
             out["cx"], out["cy"])
    log.info("dist: k1=%.4f k2=%.4f k3=%.4f p1=%.5f p2=%.5f", out["k1"],
             out["k2"], out["k3"], out["p1"], out["p2"])
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
