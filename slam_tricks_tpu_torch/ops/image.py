"""Image resampling and filtering: nearest and bilinear sampling, whole-image
undistortion, 'same' correlation, the separable Gaussian and Sobel gradients
(port of ``slam_tricks_tpu/ops/image.py``; st1 undistort_img.hpp:30-133,
st10 detector.cpp:267-300).

Plain torch: a sampler is one gather of the four neighbours over any
leading shape of points, a filter one ``F.conv2d`` (a correlation, as
``lax.conv_general_dilated`` is: no kernel flip), zero padded as XLA's
"SAME". Every convolution runs with TF32 off (``set_full_precision``), the
JAX package's ``Precision.HIGHEST``.
"""

import torch
import torch.nn.functional as F

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.residuals.camera import distort_normalized
from slam_tricks_tpu_torch.solvers.common import set_full_precision


def sample_nearest(img, xy):
    """img (H, W) or (H, W, C); xy (..., 2) in (x, y) pixel coordinates ->
    samples (...) or (..., C); coordinates rounded half to even and clipped
    into the image."""
    H, W = img.shape[:2]
    x = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0, H - 1)
    return img[y, x]


def sample_bilinear(img, xy):
    """Bilinear sampling of img (H, W) or (H, W, C) at xy (..., 2) (x, y),
    clipped into the image; differentiable in xy (forward and reverse
    mode), as the JAX package's is."""
    H, W = img.shape[:2]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    if img.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy


def undistort_image(img, intr, dist, interpolation="bilinear"):
    """Whole-image undistortion (undistort_img.hpp:104-130): each output
    (undistorted) pixel's coordinates are forward-distorted through
    ``camera.distort_normalized`` and the source sampled there (bilinear or
    nearest). img (H, W[, C]) -> the same shape and dtype."""
    H, W = img.shape[:2]
    dtype = img.dtype if img.is_floating_point() else torch.float32
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dtype, device=img.device),
                            torch.arange(W, dtype=dtype, device=img.device),
                            indexing="ij")
    u = (xs - intr.cx) / intr.fx
    v = (ys - intr.cy) / intr.fy
    pd = distort_normalized(dist, torch.stack([u, v], dim=-1))
    xy = torch.stack([pd[..., 0] * intr.fx + intr.cx,
                      pd[..., 1] * intr.fy + intr.cy], dim=-1)
    fimg = img.to(xy.dtype)
    out = (sample_bilinear(fimg, xy) if interpolation == "bilinear"
           else sample_nearest(fimg, xy))
    return out.to(img.dtype)


def conv2d(img, kernel):
    """'Same' 2-D correlation of img (H, W) with kernel (kh, kw), zero
    padded as XLA's "SAME" ((k - 1) // 2 before, the rest after): the
    filter2D analogue."""
    set_full_precision()
    kh, kw = kernel.shape
    padded = F.pad(img[None, None], ((kw - 1) // 2, kw // 2,
                                     (kh - 1) // 2, kh // 2))
    return F.conv2d(padded, kernel[None, None].to(img.dtype))[0, 0]


def gaussian_kernel1d(sigma, radius=None, dtype=torch.float32, device=None):
    """Normalized Gaussian taps exp(-x^2 / 2 sigma^2), x in [-radius,
    radius] (radius int(3 sigma + 0.5) by default), on `device` (the
    card unless the caller names another)."""
    if radius is None:
        radius = int(3.0 * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=resolve(device))
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img, sigma):
    """Separable Gaussian of img (H, W) (the detector's Gaussian filter,
    st10 helper.cpp:165-177): a row pass, then a column pass."""
    k = gaussian_kernel1d(sigma, dtype=img.dtype, device=img.device)
    img = conv2d(img, k[None, :])
    return conv2d(img, k[:, None])


def sobel(img):
    """(gx, gy) 3x3 Sobel gradients of img (H, W) (detector.cpp:269-272)."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype,
                      device=img.device)
    return conv2d(img, kx), conv2d(img, kx.T)
