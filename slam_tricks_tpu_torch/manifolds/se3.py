"""SE(3) as a pair (R (..., 3, 3), t (..., 3)), batched over leading dims.

Port of ``slam_tricks_tpu/manifolds/se3.py``. Tangent order is
[rho (translation), omega (rotation)], the Sophus convention.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import so3


class SE3(NamedTuple):
    """R: (..., 3, 3) rotation, t: (..., 3) translation."""
    R: torch.Tensor
    t: torch.Tensor


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def exp(xi):
    """xi = [rho, omega] (..., 6) -> SE3(exp(omega), Jl(omega) rho)."""
    rho, w = xi[..., :3], xi[..., 3:]
    return SE3(so3.exp(w), _matvec(so3.jl(w), rho))


def log(T):
    """SE3 -> [rho, omega] (..., 6), rho = Jl(omega)^-1 t."""
    w = so3.log(T.R)
    return torch.cat([_matvec(so3.jl_inv(w), T.t), w], dim=-1)


def mul(Ta, Tb):
    return SE3(Ta.R @ Tb.R, _matvec(Ta.R, Tb.t) + Ta.t)


def inv(T):
    Rt = T.R.mT
    return SE3(Rt, -_matvec(Rt, T.t))


def act(T, p):
    """T p for points p (..., 3) under poses of the same leading shape."""
    return _matvec(T.R, p) + T.t


def retract(T, xi):
    """Right perturbation T exp(xi)."""
    return mul(T, exp(xi))
