"""Direct (photometric) SE(3) alignment of two intensity images given the
depth at sampled pixels (port of ``slam_tricks_tpu/frontend/direct.py``;
st13 direct.cpp:4-16 left it a skeleton):

    r_i = I2( pi( T_21 pi^-1(p_i, d_i) ) ) - I1(p_i)

over high-gradient pixels (the sparse-direct selection). The generic LM
solver (``solvers.lm``) drives it on ``lie(se3)``; its Jacobian is
``torch.func.jacfwd`` through the bilinear sampler, as the JAX package
differentiates through its sampler. The 6 x 6 damped system goes to the
unrolled small Cholesky (``common.solve_damped_normal``), no kernel.
"""

import torch

from slam_tricks_tpu_torch.manifolds import lie, se3
from slam_tricks_tpu_torch.ops.image import sample_bilinear, sobel
from slam_tricks_tpu_torch.ops.nms import top_k_peaks
from slam_tricks_tpu_torch.solvers.lm import levenberg_marquardt


def select_pixels(img, k=512, nms_radius=3, margin=8):
    """High-gradient pixel sites (the increasePixPts role): the k strongest
    squared Sobel magnitudes after NMS, `margin` pixels inside the image.
    Returns (xy (k, 2) float (x, y), valid (k,))."""
    gx, gy = sobel(img)
    mag = gx * gx + gy * gy
    H, W = img.shape
    border = torch.zeros_like(mag)
    border[margin:H - margin, margin:W - margin] = 1.0
    scores, rows, cols = top_k_peaks(mag * border, k, nms_radius, 1e-6)
    xy = torch.stack([cols, rows], dim=1).to(img.dtype)
    return xy, torch.isfinite(scores)


def photometric_residual(T_21, img1, img2, xy1, depth1, intr, valid):
    """(k,) intensity residuals I2(warp) - I1; 0 where a pixel is invalid,
    behind camera 2 or outside img2's one-pixel border."""
    u = (xy1[:, 0] - intr.cx) / intr.fx
    v = (xy1[:, 1] - intr.cy) / intr.fy
    p1 = torch.stack([u * depth1, v * depth1, depth1], dim=1)
    p2 = se3.act(T_21, p1)
    z_ok = p2[:, 2] > 1e-3
    z = torch.where(z_ok, p2[:, 2], torch.ones_like(p2[:, 2]))
    x2 = intr.fx * p2[:, 0] / z + intr.cx
    y2 = intr.fy * p2[:, 1] / z + intr.cy
    H, W = img2.shape
    inb = (x2 >= 1) & (x2 <= W - 2) & (y2 >= 1) & (y2 <= H - 2) & z_ok & valid
    i2 = sample_bilinear(img2, torch.stack([x2, y2], dim=1))
    i1 = sample_bilinear(img1, xy1)
    return torch.where(inb, i2 - i1, torch.zeros_like(i2))


def direct_pose_estimate(img1, img2, depth1_at, intr, T_init=None, k=512,
                         max_iters=30):
    """T_21 (camera 2 from camera 1) by photometric LM from T_init (the
    identity by default). depth1_at: (k,) depths at the `select_pixels`
    sites, or a function of those sites (xy (k, 2)) that returns them.
    Returns (T_21, SolveResult)."""
    xy1, valid = select_pixels(img1, k=k)
    if T_init is None:
        T_init = se3.identity(img1.dtype, device=img1.device)
    depth1 = depth1_at(xy1) if callable(depth1_at) else depth1_at

    def resid(T):
        return photometric_residual(T, img1, img2, xy1, depth1, intr, valid)

    res = levenberg_marquardt(resid, T_init, lie(se3), max_iters=max_iters,
                              lambda_init=1e-3)
    return res.x, res
