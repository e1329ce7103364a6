"""Small fit residuals, solver test problems and RANSAC demos (port of
``slam_tricks_tpu/residuals/simple.py``):

- parabola:   y = a x^2 + b x + c   (st7-ransac parabola.hpp:98-130)
- homography: 8-parameter projective warp, h22 fixed to 1
  (st9-projective projective.hpp:11-54)

Where the JAX package maps one sample with ``vmap``, these take any
leading dimensions.
"""

import torch


def parabola_residual(params, x, y):
    """params = [a, b, c]; the residual of each sample x, y (...)."""
    a, b, c = params[..., 0], params[..., 1], params[..., 2]
    return (a * x + b) * x + c - y


def parabola_fit_lsq(xs, ys, weights=None):
    """The closed-form weighted normal-equations fit (parabola.hpp:98-108):
    xs, ys (N,), weights (N,) or None -> [a, b, c]."""
    A = torch.stack([xs * xs, xs, torch.ones_like(xs)], dim=1)
    Aw = A if weights is None else A * weights[:, None]
    return torch.linalg.solve(Aw.T @ A, Aw.T @ ys)


def apply_homography(h8, p):
    """h8: the first 8 entries of H (row-major), H[2, 2] = 1; points
    p (..., 2) -> (..., 2)."""
    H = torch.cat([h8, torch.ones(1, dtype=h8.dtype, device=h8.device)]
                  ).reshape(3, 3)
    q = p @ H[:, :2].T + H[:, 2]
    return q[..., :2] / q[..., 2:]


def homography_residual(h8, src, dst):
    """The transfer residual of correspondences src -> dst (..., 2)
    (projective.hpp:25-36)."""
    return apply_homography(h8, src) - dst
