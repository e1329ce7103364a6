"""Pinhole intrinsics and radial-tangential (Brown-Conrady) distortion
(port of ``slam_tricks_tpu/residuals/camera.py``).

Where the JAX package maps single points with ``vmap``, every function here
takes points with any leading dimensions (..., 2), a single point (2,)
included; the ``*_points`` / ``*_pixels`` names are the same functions.
``undistort_points_fast`` runs the CUDA kernel ``ops/undistort`` on a CUDA
tensor; ``undistort_point_gn`` is the generic Newton iteration in plain
torch, with the exact 2x2 step or the reference's diagonal one.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.ops import undistort as _undistort


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (fx, fy, cx, cy): numbers or 0-d tensors."""
    fx: object
    fy: object
    cx: object
    cy: object

    @property
    def K(self):
        fx, fy, cx, cy = (torch.as_tensor(v) for v in self)
        one, zero = torch.ones_like(fx), torch.zeros_like(fx)
        return torch.stack([torch.stack([fx, zero, cx]),
                            torch.stack([zero, fy, cy]),
                            torch.stack([zero, zero, one])])

    @classmethod
    def from_K(cls, K):
        return cls(K[0, 0], K[1, 1], K[0, 2], K[1, 2])


class DistCoeffs(NamedTuple):
    """Radial (k1, k2, k3) and tangential (p1, p2) coefficients."""
    k1: object
    k2: object
    k3: object
    p1: object
    p2: object

    @classmethod
    def zeros(cls):
        return cls(0.0, 0.0, 0.0, 0.0, 0.0)

    @classmethod
    def from_opencv(cls, d):
        """OpenCV order [k1, k2, p1, p2, k3]."""
        return cls(d[0], d[1], d[4], d[2], d[3])

    def to_opencv(self):
        return torch.stack([torch.as_tensor(v) for v in
                            (self.k1, self.k2, self.p1, self.p2, self.k3)])


def project(intr, p_norm):
    """Normalized plane (..., 2) -> pixels (..., 2)."""
    return torch.stack([intr.fx * p_norm[..., 0] + intr.cx,
                        intr.fy * p_norm[..., 1] + intr.cy], dim=-1)


def unproject(intr, px):
    """Pixels (..., 2) -> normalized plane (..., 2)."""
    return torch.stack([(px[..., 0] - intr.cx) / intr.fx,
                        (px[..., 1] - intr.cy) / intr.fy], dim=-1)


def perspective_divide(p_cam):
    """Camera-frame points (..., 3) -> the normalized plane (..., 2)."""
    return p_cam[..., :2] / p_cam[..., 2:]


def distort_normalized(dist, p):
    """Forward radial-tangential model on normalized coordinates (..., 2).

    ud = u(1 + k1 r^2 + k2 r^4 + k3 r^6) + 2 p1 u v + p2 (r^2 + 2 u^2)
    vd = v(1 + k1 r^2 + k2 r^4 + k3 r^6) + p1 (r^2 + 2 v^2) + 2 p2 u v
    """
    u, v = p[..., 0], p[..., 1]
    r2 = u * u + v * v
    radial = 1.0 + r2 * (dist.k1 + r2 * (dist.k2 + r2 * dist.k3))
    du = 2.0 * dist.p1 * u * v + dist.p2 * (r2 + 2.0 * u * u)
    dv = dist.p1 * (r2 + 2.0 * v * v) + 2.0 * dist.p2 * u * v
    return torch.stack([u * radial + du, v * radial + dv], dim=-1)


def distort_pixel(intr, dist, px):
    """Pixels (..., 2) -> distorted pixels, through the normalized plane."""
    return project(intr, distort_normalized(dist, unproject(intr, px)))


distort_pixels = distort_pixel


def _distort_jacobian(dist, u, v):
    """The 2x2 Jacobian (Juu, Juv, Jvu, Jvv) of ``distort_normalized`` at
    (u, v), in closed form: the function the JAX package takes with
    ``jacfwd``."""
    k1, k2, k3, p1, p2 = dist
    r2 = u * u + v * v
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dr = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)  # d(radial)/d(r2)
    Juu = radial + 2.0 * u * u * dr + 2.0 * p1 * v + 6.0 * p2 * u
    Juv = 2.0 * u * v * dr + 2.0 * p1 * u + 2.0 * p2 * v
    Jvv = radial + 2.0 * v * v * dr + 6.0 * p1 * v + 2.0 * p2 * u
    return Juu, Juv, Juv, Jvv


def undistort_point_gn(intr, dist, px_dist, iters=5, full_jacobian=True):
    """Undistort pixels (..., 2) by `iters` Newton steps on the forward
    model, from the distorted point on the normalized plane. With
    full_jacobian the step solves the exact 2x2 system; without, it is the
    reference's decoupled diagonal step f_u / J_uu, f_v / J_vv
    (st1 undistort_pt.hpp:52-78). A fixed step count: no test on the
    data."""
    target = unproject(intr, px_dist)
    tu, tv = target[..., 0], target[..., 1]
    u, v = tu, tv
    for _ in range(iters):
        f = distort_normalized(dist, torch.stack([u, v], dim=-1))
        fu, fv = f[..., 0] - tu, f[..., 1] - tv
        a, b, c, d = _distort_jacobian(dist, u, v)
        if full_jacobian:
            det = a * d - b * c
            du, dv = (d * fu - b * fv) / det, (a * fv - c * fu) / det
        else:
            du, dv = fu / a, fv / d
        u, v = u - du, v - dv
    return project(intr, torch.stack([u, v], dim=-1))


undistort_points_gn = undistort_point_gn


def undistort_points_fast(intr, dist, px_dist, iters=5):
    """Newton undistortion with the analytic 2x2 Jacobian and its
    closed-form inverse: distorted pixels (N, 2) -> (N, 2). The CUDA kernel
    on a CUDA tensor, its plain torch version on a CPU tensor. Any (N, 2)
    view goes: the kernel gets a contiguous copy of one that is not
    contiguous or not aligned to a pixel (such as ``pts[:, :2]``)."""
    params = (intr.fx, intr.fy, intr.cx, intr.cy,
              dist.k1, dist.k2, dist.k3, dist.p1, dist.p2)
    if px_dist.device.type == "cuda" and (
            not px_dist.is_contiguous()
            or px_dist.data_ptr() % (2 * px_dist.element_size())):
        px_dist = px_dist.clone(memory_format=torch.contiguous_format)
    return _undistort.undistort(px_dist, params, iters)
