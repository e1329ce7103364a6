"""DLT homography estimation, Hartley normalized (port of
``slam_tricks_tpu/initialization/homography.py``; st9 projective.hpp:81-109,
st11 projective.cpp:5-50, st3 calib.cpp:55-93). Correspondences take
leading batch dimensions (..., N, 2) where the JAX package maps with
``vmap``.
"""

import torch

from slam_tricks_tpu_torch.initialization.eightpoint import (
    hartley_normalize, nullvec_normal)


def homography_dlt(src, dst, weights=None):
    """H (..., 3, 3) mapping src -> dst (..., N, 2), N >= 4, scaled so that
    H[2, 2] = 1 (by ||H|| where |H[2, 2]| <= 1e-12); src and dst
    broadcast against each other's leading dims."""
    n1, T1 = hartley_normalize(src)
    n2, T2 = hartley_normalize(dst)
    n1, n2 = torch.broadcast_tensors(n1, n2)
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u],
                     dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v],
                     dim=-1)
    A = torch.cat([r1, r2], dim=-2)           # two rows a correspondence
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    h, _ = nullvec_normal(A)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.solve(T2, Hn @ T1)
    h22 = H[..., 2, 2]
    div = torch.where(h22.abs() > 1e-12, h22, torch.linalg.matrix_norm(H))
    return H / div[..., None, None]


def apply_h(H, p):
    """Homography H (3, 3) applied to points p (..., 2)."""
    q = p @ H[:2, :2].T + H[:2, 2]
    w = p @ H[2, :2] + H[2, 2]
    return q / w[..., None]
