"""SE(3) as a pair (R (..., 3, 3), t (..., 3)), batched over leading dims.

Port of ``slam_tricks_tpu/manifolds/se3.py``. Tangent order is
[rho (translation), omega (rotation)], the Sophus convention.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import so3

DIM = 6


class SE3(NamedTuple):
    """R: (..., 3, 3) rotation, t: (..., 3) translation."""
    R: torch.Tensor
    t: torch.Tensor


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def identity(dtype=torch.float32, device=None):
    device = resolve(device)
    return SE3(torch.eye(3, dtype=dtype, device=device),
               torch.zeros(3, dtype=dtype, device=device))


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


def adj(T):
    """(..., 6, 6) adjoint in [rho, omega] order: [[R, hat(t) R], [0, R]]."""
    top = torch.cat([T.R, so3.hat(T.t) @ T.R], dim=-1)
    bottom = torch.cat([torch.zeros_like(T.R), T.R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def retract(T, xi):
    """Right perturbation T exp(xi)."""
    return mul(T, exp(xi))


def local(Ta, Tb):
    return log(mul(inv(Ta), Tb))


def to_matrix(T):
    """(..., 4, 4) homogeneous matrix."""
    top = torch.cat([T.R, T.t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(M):
    return SE3(M[..., :3, :3], M[..., :3, 3])


def random(generator, dtype=torch.float32, trans_scale=1.0, shape=(),
           device=None):
    """Random poses of batch `shape`: a uniform rotation and a normal
    translation of scale trans_scale, drawn with `generator`."""
    R = so3.random(generator, dtype, shape, device)
    t = torch.randn(*shape, 3, generator=generator, dtype=dtype,
                    device=generator.device).to(R.device)
    return SE3(R, trans_scale * t)
