"""SE(2) as a pair (theta (...), t (..., 2)), batched over leading dims.

Port of ``slam_tricks_tpu/manifolds/se2.py``. Tangent order is
[rho (2), omega (1)], the Sophus convention.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import _coeffs, so2

DIM = 3


class SE2(NamedTuple):
    theta: torch.Tensor  # (...) angle
    t: torch.Tensor      # (..., 2)


def identity(dtype=torch.float32, device=None):
    device = resolve(device)
    return SE2(torch.zeros((), dtype=dtype, device=device),
               torch.zeros(2, dtype=dtype, device=device))


def _V(w):
    """(..., 2, 2) translation map of exp: [[A, -B w], [B w, A]] with
    A = sin(w)/w, B w = (1 - cos w)/w."""
    w_sq = w * w
    a = _coeffs.sinc(w_sq)
    b = _coeffs.cosc(w_sq) * w
    return torch.stack([torch.stack([a, -b], dim=-1),
                        torch.stack([b, a], dim=-1)], dim=-2)


def exp(xi):
    rho, w = xi[..., :2], xi[..., 2]
    return SE2(so2.wrap(w), (_V(w) @ rho[..., None])[..., 0])


def log(T):
    w = so2.wrap(T.theta)
    rho = torch.linalg.solve_ex(_V(w), T.t[..., None]).result[..., 0]
    return torch.cat([rho, w[..., None]], dim=-1)


def mul(Ta, Tb):
    return SE2(so2.mul(Ta.theta, Tb.theta), so2.act(Ta.theta, Tb.t) + Ta.t)


def inv(T):
    return SE2(-T.theta, -so2.act(-T.theta, T.t))


def act(T, p):
    return so2.act(T.theta, p) + T.t


def retract(T, xi):
    return mul(T, exp(xi))


def local(Ta, Tb):
    return log(mul(inv(Ta), Tb))


def matrix(T):
    """(..., 3, 3) homogeneous matrix."""
    top = torch.cat([so2.matrix(T.theta), T.t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 2] = 1.0
    return torch.cat([top, bottom], dim=-2)
