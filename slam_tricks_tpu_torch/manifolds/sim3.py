"""Sim(3) as (R (..., 3, 3), t (..., 3), s (...)), batched over leading
dims: the scale-drift group of monocular loop closing.

Port of ``slam_tricks_tpu/manifolds/sim3.py``. Tangent order is
[rho (translation), omega (rotation), sigma (log scale)]. exp and log need
W(omega, sigma) = phi1(sigma I + hat(omega)), phi1(M) = integral_0^1
e^{sM} ds, which is evaluated as the JAX package does it: branch-free
scaling and squaring from Taylor seeds, with no regime switch in either
dtype.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import so3

DIM = 7  # tangent dimension: [rho, omega, sigma]

_PHI_SQUARINGS = 6  # ||M|| / 2^6 <= ~0.13 for theta <= pi, |sigma| <= 5
_PHI_TAYLOR_ORDER = 7


class Sim3(NamedTuple):
    """R: (..., 3, 3) rotation, t: (..., 3) translation, s: (...) scale."""
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def identity(dtype=torch.float32, device=None):
    device = resolve(device)
    return Sim3(torch.eye(3, dtype=dtype, device=device),
                torch.zeros(3, dtype=dtype, device=device),
                torch.ones((), dtype=dtype, device=device))


def _phi1(M):
    """phi1(M) (..., n, n): Taylor seeds E ~ e^{M/2^k}, P ~ phi1(M/2^k),
    then k times phi1(2A) = 1/2 phi1(A) (I + e^A) and e^{2A} = (e^A)^2.
    Also the left Jacobian phi1(ad) of SE(3) and Sim(3) (the pose-graph
    solvers' edge Jacobians): its accuracy depends on the diagonal blocks
    (omega, sigma) only, which ad's off-diagonal blocks enter linearly."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Ms = M * (1.0 / (1 << _PHI_SQUARINGS))
    E = P = term = eye
    for n in range(1, _PHI_TAYLOR_ORDER + 1):
        term = term @ Ms * (1.0 / n)
        E = E + term
        P = P + term * (1.0 / (n + 1))
    for _ in range(_PHI_SQUARINGS):
        P = 0.5 * (P @ (eye + E))
        E = E @ E
    return P


def _W(w, sigma):
    """W(omega, sigma) = phi1(sigma I + hat(omega)), the Sim(3) analog of
    the SO(3) left Jacobian (so3.jl at sigma = 0)."""
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return _phi1(sigma[..., None, None] * eye + so3.hat(w))


def exp(xi):
    """xi = [rho, omega, sigma] (..., 7) -> Sim3(exp(omega),
    W(omega, sigma) rho, e^sigma)."""
    rho, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return Sim3(so3.exp(w), _matvec(_W(w, sigma), rho), torch.exp(sigma))


def log(S):
    """Inverse of exp; rho solves W rho = t (a 3x3 solve; ``solve_ex``
    checks no pivot, so it does not sync with the card: W is regular for
    theta < 2 pi)."""
    w = so3.log(S.R)
    sigma = torch.log(S.s)
    rho = torch.linalg.solve_ex(_W(w, sigma), S.t[..., None]).result[..., 0]
    return torch.cat([rho, w, sigma[..., None]], dim=-1)


def mul(Sa, Sb):
    return Sim3(Sa.R @ Sb.R, Sa.s[..., None] * _matvec(Sa.R, Sb.t) + Sa.t,
                Sa.s * Sb.s)


def inv(S):
    Rt = S.R.mT
    return Sim3(Rt, -_matvec(Rt, S.t) / S.s[..., None], 1.0 / S.s)


def act(S, p):
    """s R p + t for points p (..., 3); S broadcasts against p's leading
    dims."""
    return S.s[..., None] * _matvec(S.R, p) + S.t


def adj(S):
    """(..., 7, 7) adjoint in [rho, omega, sigma] order:
    [[s R, hat(t) R, -t], [0, R, 0], [0, 0, 1]]."""
    R = S.R
    z3 = torch.zeros_like(R[..., :, :1])
    top = torch.cat([S.s[..., None, None] * R, so3.hat(S.t) @ R,
                     -S.t[..., None]], dim=-1)
    mid = torch.cat([torch.zeros_like(R), R, z3], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 6] = 1.0
    return torch.cat([top, mid, bottom], dim=-2)


def retract(S, xi):
    """Right perturbation S exp(xi)."""
    return mul(S, exp(xi))


def local(Sa, Sb):
    return log(mul(inv(Sa), Sb))


def to_matrix(S):
    """(..., 4, 4) matrix [[s R, t], [0, 1]]."""
    top = torch.cat([S.s[..., None, None] * S.R, S.t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(M):
    """Inverse of to_matrix, the scale the cube root of det of the upper
    3x3, as the JAX package takes it: a negative determinant gives a
    negative scale."""
    A = M[..., :3, :3]
    d = torch.linalg.det(A)
    s = torch.sign(d) * d.abs() ** (1.0 / 3.0)
    return Sim3(A / s[..., None, None], M[..., :3, 3], s)


def from_se3(T, s=None):
    """Lift an SE(3) pose (``se3.SE3``) to Sim(3), scale 1 or `s`."""
    lead = T.t.shape[:-1]
    scale = (torch.ones(lead, dtype=T.R.dtype, device=T.R.device) if s is None
             else torch.as_tensor(s, dtype=T.R.dtype, device=T.R.device))
    return Sim3(T.R, T.t, scale)


def random(generator, dtype=torch.float32, trans_scale=1.0, log_scale=0.3,
           shape=(), device=None):
    """Random similarities of batch `shape`, drawn with `generator`: a
    uniform rotation, a normal translation of scale trans_scale and a
    log-normal scale of log-deviation log_scale."""
    R = so3.random(generator, dtype, shape, device)
    t = torch.randn(*shape, 3, generator=generator, dtype=dtype,
                    device=generator.device).to(R.device)
    z = torch.randn(*shape, generator=generator, dtype=dtype,
                    device=generator.device).to(R.device)
    return Sim3(R, trans_scale * t, torch.exp(log_scale * z))
