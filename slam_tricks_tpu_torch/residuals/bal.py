"""BAL's camera ("Bundle Adjustment in the Large", Agarwal, Snavely,
Seitz and Szeliski, ECCV 2010): a pose and its own focal length f and
radial distortion k1, k2, nine parameters a camera.

    p = R X + t,  x = p.xy / p.z,  r2 = |x|²,
    uv = f (1 + k1 r2 + k2 r2²) x,  residual d = uv - uv_measured (pixels)

The port's cameras look along +z. BAL's files write their cameras looking
along -z (x = -p.xy / p.z): a rotation of pi about the camera's z axis
(R, t -> diag(-1, -1, 1) R, diag(-1, -1, 1) t) turns such a camera into
the port's, flipping the sign of p.xy and so of x, and leaves every
measurement and every other number as it is.

The tangent is [omega, dt, df, dk1, dk2]: R exp(omega), t + dt, and the
intrinsics moved additively. The Jacobians are analytic; the slot-major
kernel (``ops/ba_assemble.py``, ``csrc/ba_assemble.cu``) computes the same
terms.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import so3


class BALCameras(NamedTuple):
    """Stacked BAL cameras: R (..., 3, 3) and t (..., 3) world-to-camera,
    intr (..., 3) = [f, k1, k2]."""
    R: torch.Tensor
    t: torch.Tensor
    intr: torch.Tensor


def retract(cams, dp):
    """The step [omega, dt, df, dk1, dk2] (..., 9) on BAL's cameras."""
    return BALCameras(so3.retract(cams.R, dp[..., :3]), cams.t + dp[..., 3:6],
                      cams.intr + dp[..., 6:])


def project(cams, X):
    """Pixel projection uv (..., 2) of world points X (..., 3)."""
    p = (cams.R @ X[..., None])[..., 0] + cams.t
    x = p[..., :2] / p[..., 2:]
    r2 = (x * x).sum(-1, keepdim=True)
    f, k1, k2 = cams.intr[..., 0:1], cams.intr[..., 1:2], cams.intr[..., 2:3]
    return f * (1.0 + r2 * (k1 + k2 * r2)) * x


def residual(cams, X, uv):
    """uv_predicted - uv (..., 2)."""
    return project(cams, X) - uv


def jacobians(cams, X):
    """(uv (..., 2), J_cam (..., 2, 9) in [omega, dt, df, dk1, dk2],
    J_point (..., 2, 3)), analytic: d(uv)/dx = f a I + 2 f (k1 + 2 k2 r2)
    x xᵀ with a = 1 + k1 r2 + k2 r2²."""
    R = cams.R
    p = (R @ X[..., None])[..., 0] + cams.t
    iz = 1.0 / p[..., 2]
    x = p[..., :2] * iz[..., None]
    r2 = (x * x).sum(-1)
    f, k1, k2 = cams.intr[..., 0], cams.intr[..., 1], cams.intr[..., 2]
    a = 1.0 + r2 * (k1 + k2 * r2)
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    dudx = ((f * a)[..., None, None] * eye2
            + (2.0 * f * (k1 + 2.0 * k2 * r2))[..., None, None]
            * x[..., :, None] * x[..., None, :])
    zero = torch.zeros_like(iz)
    dxdp = torch.stack([torch.stack([iz, zero, -x[..., 0] * iz], -1),
                        torch.stack([zero, iz, -x[..., 1] * iz], -1)], -2)
    dudp = dudx @ dxdp                                         # (..., 2, 3)
    J_point = dudp @ R
    J_omega = -(J_point @ so3.hat(X))
    J_intr = torch.stack([a[..., None] * x, (f * r2)[..., None] * x,
                          (f * r2 * r2)[..., None] * x], -1)   # (..., 2, 3)
    uv = (f * a)[..., None] * x
    return uv, torch.cat([J_omega, dudp, J_intr], -1), J_point
