"""Zhang calibration: the closed-form start, then one joint LM refinement
of 4 intrinsics, 5 distortion coefficients and 6 DoF a view (port of
``slam_tricks_tpu/pipelines/calibration.py``; the reference's 9 + 6V
refinement, st3-calibration calib.cpp:38-47, 282-422), as one generic
``solvers.lm.levenberg_marquardt`` call on the product manifold
euclidean(9) x V SE(3). Its normal system has n = 9 + 6V unknowns (63 at 9
views): above 16, ``common.solve_damped_normal`` solves it with the
``spd_solve`` kernel on the card.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.initialization.zhang import calibrate_closed_form
from slam_tricks_tpu_torch.manifolds import (batched, euclidean, lie,
                                             product, se3)
from slam_tricks_tpu_torch.residuals.calib import (calib_residual,
                                                   pack_intrinsics,
                                                   unpack_intrinsics)
from slam_tricks_tpu_torch.residuals.camera import DistCoeffs, Intrinsics
from slam_tricks_tpu_torch.solvers.lm import levenberg_marquardt


class CalibResult(NamedTuple):
    intrinsics: Intrinsics
    distortion: DistCoeffs
    poses: se3.SE3          # (V,) T_cw
    final_cost: torch.Tensor
    rms_px: torch.Tensor
    iterations: int


def calibrate(board_pts, image_pts, *, max_iters=50, init=None):
    """board_pts (P, 2) model-plane corners, image_pts (V, P, 2) pixel
    corners. init: (intrinsics0, poses0) in place of the closed-form start
    (``initialization.zhang.calibrate_closed_form``); the distortion
    starts at 0. Returns a CalibResult."""
    V, P, _ = image_pts.shape
    if init is None:
        intr0, _, poses0 = calibrate_closed_form(board_pts, image_pts)
    else:
        intr0, poses0 = init
    x0 = (pack_intrinsics(intr0, DistCoeffs.zeros()).to(image_pts.dtype),
          poses0)
    manifold = product(euclidean(9), batched(lie(se3), V))

    def residual(x):
        vec, poses = x
        intr, dist = unpack_intrinsics(vec)
        T = se3.SE3(poses.R[:, None], poses.t[:, None])
        return calib_residual(intr, dist, T, board_pts, image_pts)  # (V,P,2)

    res = levenberg_marquardt(residual, x0, manifold, max_iters=max_iters)
    vec, poses = res.x
    intr, dist = unpack_intrinsics(vec)
    return CalibResult(intrinsics=intr, distortion=dist, poses=poses,
                       final_cost=res.cost,
                       rms_px=torch.sqrt(2.0 * res.cost / (V * P * 2)),
                       iterations=res.iterations)
