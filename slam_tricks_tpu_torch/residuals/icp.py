"""Closed-form point-set alignment (the part of
``slam_tricks_tpu/residuals/icp.py`` that trajectory evaluation uses)."""

import torch


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
