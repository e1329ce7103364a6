"""Pyramidal Lucas-Kanade optical flow (port of
``slam_tricks_tpu/frontend/optical_flow.py``; st5 opticalflow.hpp:64 wraps
cv::calcOpticalFlowPyrLK, grid seeding :110-163).

Coarse to fine over a Gaussian pyramid; at each level every point refines
its flow by a fixed count of Gauss-Newton steps on bilinear-sampled
patches. Where the JAX package maps one point's ``fori_loop`` with
``vmap``, the port runs one Python loop of that fixed count over the whole
batch of points: no test on the data, one stream of batched operations.
Grid seeding is a host helper in numpy, the JAX package's own, so both
packages seed the same points.
"""

import numpy as np
import torch

from slam_tricks_tpu_torch.ops.image import (gaussian_blur, sample_bilinear,
                                             sobel)


def build_pyramid(img, levels=3):
    """[img, ...]: level 0 at full resolution, each next level the last
    blurred (sigma 1) and taken at every second row and column."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(gaussian_blur(pyr[-1], 1.0)[::2, ::2])
    return pyr


def _window_offsets(win, dtype, device):
    """(K, 2) (dx, dy) offsets of a (2 win + 1)^2 window, x fastest."""
    r = torch.arange(-win, win + 1, dtype=dtype, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=1)


def _lk_level(img1, img2, pts1, guess, win=7, iters=10, min_eig=1e-4):
    """One pyramid level: refine the flow `guess` (N, 2) of pts1 (N, 2)
    (x, y). Returns (flow (N, 2), valid (N,)): a point whose structure
    tensor's least eigenvalue is below min_eig a window pixel keeps its
    guess."""
    gx, gy = sobel(img1)
    offs = _window_offsets(win, img1.dtype, img1.device)
    patch_xy = pts1[:, None, :] + offs                   # (N, K, 2)
    t = sample_bilinear(img1, patch_xy)                  # the templates
    jx = sample_bilinear(gx, patch_xy)
    jy = sample_bilinear(gy, patch_xy)
    a = torch.sum(jx * jx, dim=1)
    b = torch.sum(jx * jy, dim=1)
    c = torch.sum(jy * jy, dim=1)
    det = a * c - b * b
    tr = a + c
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp_min(tr * tr - 4 * det, 0.0)))
    ok = eig_min > min_eig * offs.shape[0]
    pos = det > 1e-12
    inv_det = torch.where(pos, 1.0 / torch.where(pos, det,
                                                 torch.ones_like(det)),
                          torch.zeros_like(det))
    flow = guess
    for _ in range(iters):
        e = sample_bilinear(img2, patch_xy + flow[:, None, :]) - t
        bx = torch.sum(jx * e, dim=1)
        by = torch.sum(jy * e, dim=1)
        du = inv_det * (c * bx - b * by)
        dv = inv_det * (a * by - b * bx)
        flow = flow - torch.stack([du, dv], dim=1)
    return torch.where(ok[:, None], flow, guess), ok


def lk_track(img1, img2, pts1, *, levels=3, win=7, iters=10):
    """Track pts1 (N, 2) from img1 to img2 (H, W): (pts2 (N, 2), valid
    (N,)). The flow of each level is doubled into the next finer one (the
    cv::calcOpticalFlowPyrLK contract, opticalflow.hpp:64); valid also
    needs pts2 at least win pixels inside the image."""
    p1 = build_pyramid(img1, levels)
    p2 = build_pyramid(img2, levels)
    flow = torch.zeros_like(pts1)
    valid = torch.ones(pts1.shape[0], dtype=torch.bool, device=pts1.device)
    for lv in range(levels - 1, -1, -1):
        s = 2.0 ** lv
        flow, ok = _lk_level(p1[lv], p2[lv], pts1 / s, flow, win=win,
                             iters=iters)
        valid = valid & ok
        if lv > 0:
            flow = flow * 2.0
    pts2 = pts1 + flow
    H, W = img1.shape
    inb = ((pts2[:, 0] >= win) & (pts2[:, 0] < W - win)
           & (pts2[:, 1] >= win) & (pts2[:, 1] < H - win))
    return pts2, valid & inb


def grid_seed_points(h, w, grid=8, pts_per_cell=2, margin=12, seed=0):
    """Host helper: pts_per_cell random seeds in each cell of a grid x grid
    partition of the image inside `margin` (st5 initGrids,
    opticalflow.hpp:110-136). Returns (N, 2) float32 numpy (x, y)."""
    rng = np.random.default_rng(seed)
    pts = []
    ch, cw = (h - 2 * margin) / grid, (w - 2 * margin) / grid
    for gy in range(grid):
        for gx in range(grid):
            for _ in range(pts_per_cell):
                x = margin + (gx + rng.random()) * cw
                y = margin + (gy + rng.random()) * ch
                pts.append((x, y))
    return np.asarray(pts, np.float32)
