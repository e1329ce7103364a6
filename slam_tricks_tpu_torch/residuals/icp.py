"""ICP: point-to-point residuals in SE(2) and SE(3), nearest-neighbour
association, closed-form alignment and the unknown-correspondence loop
(port of ``slam_tricks_tpu/residuals/icp.py``; st6-icp icp.hpp).

Where the JAX package maps one correspondence with ``vmap``, the residuals
take points with any leading dimensions.
"""

import torch

from slam_tricks_tpu_torch.manifolds import se2, se3

# source rows a chunk of the nearest-neighbour search: the (rows, M, d)
# differences stay within ~2^25 elements (128 MB in f32)
_NN_ELEMENTS = 1 << 25


def point_residual_se2(T, src, dst):
    """T src - dst for 2D correspondences (icp.hpp:33-43)."""
    return se2.act(T, src) - dst


def point_residual_se3(T, src, dst):
    """T src - dst for 3D correspondences."""
    return se3.act(T, src) - dst


def nearest_neighbors(src, dst):
    """For each src point (N, d), the index (N,) int64 of its nearest dst
    point (M, d): the explicit squared differences summed and their argmin
    (ties to the first index), as the JAX package computes them, chunked
    over source rows. Not ‖a‖² + ‖b‖² − 2a·b (``torch.cdist``'s route for
    large inputs), which in f32 changes the argmin."""
    rows = max(1, _NN_ELEMENTS // max(dst.shape[0] * dst.shape[1], 1))
    return torch.cat([
        ((s[:, None, :] - dst[None, :, :]) ** 2).sum(dim=-1).argmin(dim=1)
        for s in src.split(rows)])


def umeyama(src, dst, with_scale=False):
    """The least-squares alignment dst ~ s R src + t of (N, d) point sets
    (Umeyama / Kabsch). Returns (R (d, d), t (d,), s ())."""
    dim = src.shape[1]
    mu_s = src.mean(dim=0)
    mu_d = dst.mean(dim=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.cat([torch.ones(dim - 1, dtype=src.dtype, device=src.device),
                   d[None]])
    R = (U * D[None, :]) @ Vt
    if with_scale:
        var_s = (sc * sc).sum(dim=1).mean()
        s = (S * D).sum() / var_s
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * (R @ mu_s)
    return R, t, s


def icp_iterate(src, dst, n_outer=10, with_scale=False):
    """Unknown-correspondence ICP (icp.hpp:63-95): n_outer sweeps of
    nearest-neighbour association and closed-form ``umeyama`` alignment, a
    fixed count with no test on the data, from R = I and t the centroids'
    difference. Clouds (N, d) and (M, d), d = 2 or 3. Returns (R, t, s,
    assoc_idx (N,))."""
    dim = src.shape[1]
    R = torch.eye(dim, dtype=src.dtype, device=src.device)
    t = dst.mean(dim=0) - src.mean(dim=0)
    s = torch.ones((), dtype=src.dtype, device=src.device)
    for _ in range(n_outer):
        idx = nearest_neighbors(s * (src @ R.T) + t, dst)
        R, t, s = umeyama(src, dst[idx], with_scale)
    return R, t, s, nearest_neighbors(s * (src @ R.T) + t, dst)
