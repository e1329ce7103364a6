"""Epipolar residuals: the algebraic x2ᵀ F x1, point-to-epiline distances
and the Sampson error (port of ``slam_tricks_tpu/residuals/epipolar.py``;
st2-epipolar epipolar.hpp, main.cpp:127-151).

Where the JAX package maps one correspondence with ``vmap``, every
function takes F (..., 3, 3) and points p1, p2 (..., 2) that broadcast
against each other.
"""

import torch


def _h(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def algebraic(F, p1, p2):
    """x2ᵀ F x1, (...)."""
    return (_h(p2) * _matvec(F, _h(p1))).sum(dim=-1)


def epiline_distance(F, p1, p2):
    """The signed point-to-epiline distances (..., 2): [d(x1, Fᵀ x2),
    d(x2, F x1)]."""
    l2 = _matvec(F, _h(p1))
    l1 = _matvec(F.mT, _h(p2))
    a = algebraic(F, p1, p2)
    d2 = a / torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2)
    d1 = a / torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2)
    return torch.stack([d1, d2], dim=-1)


def sampson(F, p1, p2):
    """The first-order geometric (Sampson) error, (...)."""
    x1, x2 = _h(p1), _h(p2)
    Fx1 = _matvec(F, x1)
    Ftx2 = _matvec(F.mT, x2)
    num = (x2 * Fx1).sum(dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 \
        + Ftx2[..., 1] ** 2
    return num / den
