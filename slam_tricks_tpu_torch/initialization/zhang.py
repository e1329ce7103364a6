"""Zhang's closed-form calibration: the intrinsics from the homographies'
constraints on B = K^-T K^-1 and each view's extrinsics (port of
``slam_tricks_tpu/initialization/zhang.py``; st3-calibration
calib.cpp:55-173). The start of the joint refinement
(``pipelines.calibration``).
"""

import torch

from slam_tricks_tpu_torch.initialization.homography import homography_dlt
from slam_tricks_tpu_torch.manifolds import se3, so3
from slam_tricks_tpu_torch.residuals.camera import Intrinsics


def _v_ij(H, i, j):
    """Zhang's constraint rows v_ij (..., 6) from homography columns
    (calib.cpp:103-118)."""
    hi, hj = H[..., :, i], H[..., :, j]
    return torch.stack([
        hi[..., 0] * hj[..., 0],
        hi[..., 0] * hj[..., 1] + hi[..., 1] * hj[..., 0],
        hi[..., 1] * hj[..., 1],
        hi[..., 2] * hj[..., 0] + hi[..., 0] * hj[..., 2],
        hi[..., 2] * hj[..., 1] + hi[..., 1] * hj[..., 2],
        hi[..., 2] * hj[..., 2],
    ], dim=-1)


def intrinsics_from_homographies(Hs):
    """Hs (V, 3, 3), V >= 3 -> (Intrinsics, skew): b the smallest right
    singular vector of the (2V, 6) constraints, then Zhang's closed form
    (calib.cpp:120-140), which is the same for b and -b."""
    A = torch.stack([_v_ij(Hs, 0, 1),
                     _v_ij(Hs, 0, 0) - _v_ij(Hs, 1, 1)], dim=1)
    _, _, Vt = torch.linalg.svd(A.reshape(-1, 6), full_matrices=False)
    B11, B12, B22, B13, B23, B33 = Vt[-1]
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    return Intrinsics(alpha, beta, u0, v0), gamma


def extrinsics_from_homography(K, H):
    """Each view's T_cw from H = K [r1 r2 t] (..., 3, 3) (calib.cpp:
    142-173): scaled by 1 / ||K^-1 h1|| with the board in front (t_z > 0),
    r3 = r1 x r2, projected onto SO(3)."""
    KH = torch.linalg.solve(K, H)
    h1, h2, h3 = KH[..., :, 0], KH[..., :, 1], KH[..., :, 2]
    s = torch.sign(h3[..., 2]) / torch.linalg.vector_norm(h1, dim=-1)
    r1, r2, t = s[..., None] * h1, s[..., None] * h2, s[..., None] * h3
    R = so3.project(torch.stack([r1, r2, torch.linalg.cross(r1, r2)],
                                dim=-1))
    return se3.SE3(R, t)


def calibrate_closed_form(board_pts, image_pts):
    """Zhang's start: board_pts (P, 2) model-plane corners, image_pts
    (V, P, 2) pixel corners. Returns (Intrinsics, skew, poses SE3 (V,))."""
    Hs = homography_dlt(board_pts, image_pts)
    intr, skew = intrinsics_from_homographies(Hs)
    return intr, skew, extrinsics_from_homography(intr.K, Hs)
