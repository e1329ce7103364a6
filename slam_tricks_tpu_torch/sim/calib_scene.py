"""Synthetic Zhang-calibration scene: a chessboard grid seen by random
views (port of ``slam_tricks_tpu/sim/calib_scene.py``; the reference's
st3 setup, a 5 x 8 board of 2.8 cm squares in 9 views, main.cpp:4).

The views, distortion and noise are made in float64 numpy by the JAX
package's random sequence, so the arrays are the same for a seed; only the
final arrays become tensors, on the card unless the caller names another
device.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.residuals.camera import DistCoeffs


class CalibScene(NamedTuple):
    board_pts: torch.Tensor   # (P, 2) model-plane corners (meters)
    image_pts: torch.Tensor   # (V, P, 2) pixels a view
    poses_true: se3.SE3       # (V,) T_cw
    fx: float
    fy: float
    cx: float
    cy: float
    dist_true: DistCoeffs


def _distort_normalized(dist, p):
    """``residuals.camera.distort_normalized`` on (N, 2) float64 numpy."""
    k1, k2, k3, p1, p2 = (float(c) for c in dist)
    u, v = p[:, 0], p[:, 1]
    r2 = u * u + v * v
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    du = 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
    dv = p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v
    return np.stack([u * radial + du, v * radial + dv], axis=1)


def make_calib_scene(rows=5, cols=8, square=0.028, n_views=9, noise=0.0,
                     dist=None, seed=0, dtype=torch.float64, device=None):
    """Board corners on the Z = 0 plane, views at random tilt and distance
    looking at the board's centre, optional radial-tangential distortion
    (a ``DistCoeffs``; None: none) and pixel noise."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = 600.0, 590.0, 320.0, 240.0
    if dist is None:
        dist = DistCoeffs.zeros()

    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    board = np.stack([xs.ravel(), ys.ravel()], axis=1) * square  # (P, 2)
    board_c = board.mean(axis=0)

    Rs, ts, img_pts = [], [], []
    for _ in range(n_views):
        R = _euler(rng.uniform(-0.5, 0.5, size=3))
        dist_z = rng.uniform(0.35, 0.7)
        offset = np.array([rng.uniform(-0.05, 0.05),
                           rng.uniform(-0.05, 0.05), dist_z])
        t = offset - R @ np.array([board_c[0], board_c[1], 0.0])
        Rs.append(R)
        ts.append(t)
        pw = np.concatenate([board, np.zeros((board.shape[0], 1))], axis=1)
        pc = pw @ R.T + t
        pn_dist = _distort_normalized(dist, pc[:, :2] / pc[:, 2:])
        uv = pn_dist * np.array([fx, fy]) + np.array([cx, cy])
        if noise > 0:
            uv = uv + rng.normal(size=uv.shape) * noise
        img_pts.append(uv)

    device = resolve(device)

    def tensor(a):
        return torch.as_tensor(np.stack(a) if isinstance(a, list) else a,
                               dtype=dtype, device=device)

    return CalibScene(board_pts=tensor(board), image_pts=tensor(img_pts),
                      poses_true=se3.SE3(tensor(Rs), tensor(ts)), fx=fx,
                      fy=fy, cx=cx, cy=cy, dist_true=dist)


def _euler(ang):
    cx_, sx = np.cos(ang[0]), np.sin(ang[0])
    cy_, sy = np.cos(ang[1]), np.sin(ang[1])
    cz, sz = np.cos(ang[2]), np.sin(ang[2])
    Rx = np.array([[1, 0, 0], [0, cx_, -sx], [0, sx, cx_]])
    Ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx
