"""Reprojection residuals for bundle adjustment (port of
``slam_tricks_tpu/residuals/reprojection.py``).

Poses are T_cw (camera from world), so a residual is one ``se3.act`` with
no inversion. Residuals are on the normalized image plane, with a
pixel-plane variant for known intrinsics. Where the JAX package maps one
observation with ``vmap``, each function here takes a batch over the
leading dimensions: poses (R (..., 3, 3), t (..., 3)) and points (..., 3).
"""

import torch

from slam_tricks_tpu_torch.manifolds import se3, so3


def reproject_normalized(T_cw, p_world, uv_norm):
    """project(T_cw p_world) - uv_norm on the normalized plane, (..., 2)."""
    p_cam = se3.act(T_cw, p_world)
    return p_cam[..., :2] / p_cam[..., 2:] - uv_norm


def reproject_pixel(intr, T_cw, p_world, uv_pix):
    """The pixel-plane residual for ``residuals.camera.Intrinsics``."""
    p_cam = se3.act(T_cw, p_world)
    u = intr.fx * p_cam[..., 0] / p_cam[..., 2] + intr.cx
    v = intr.fy * p_cam[..., 1] / p_cam[..., 2] + intr.cy
    return torch.stack([u - uv_pix[..., 0], v - uv_pix[..., 1]], dim=-1)


def _dproj_dpcam(p_cam):
    """d(normalized projection) / d(p_cam): [[1/z, 0, -x/z²], [0, 1/z,
    -y/z²]], (..., 2, 3)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([iz, zero, -x * iz2], dim=-1),
                        torch.stack([zero, iz, -y * iz2], dim=-1)], dim=-2)


def reproject_normalized_jacobians(T_cw, p_world):
    """Analytic Jacobians of the normalized-plane projection under the
    right perturbation R <- R exp(hat(omega)), t <- t + dt,
    p_world <- p_world + dp.

    Returns (prediction (..., 2), J_pose (..., 2, 6) for [omega, dt],
    J_point (..., 2, 3))."""
    R = T_cw.R
    p_cam = se3.act(T_cw, p_world)
    head = _dproj_dpcam(p_cam)
    J_omega = head @ (-(R @ so3.hat(p_world)))
    J_point = head @ R
    pred = p_cam[..., :2] / p_cam[..., 2:]
    return pred, torch.cat([J_omega, head], dim=-1), J_point
