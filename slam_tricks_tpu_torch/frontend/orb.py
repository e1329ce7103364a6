"""ORB-style features: FAST-9 detection over the whole image, Harris
ranking, intensity-centroid orientation and steered binary-test
descriptors matched by one matrix product (port of
``slam_tricks_tpu/frontend/orb.py``; the reference's ORB detectAndMatch,
st0 struct_def.hpp:113-134, used by st11's panorama).

- FAST-9: the 16 Bresenham-circle comparisons are 16 rolled copies of the
  image (``torch.roll``, the JAX package's shifts); "9 contiguous" is a
  windowed count of 9 over the circle's 16 masks (a cumulative sum over
  the circle, wrapped), the same mask as the JAX package's AND-products.
- Ranking: the Harris response at FAST corners, NMS and the top n.
- Orientation: the intensity-centroid moments m10 and m01 of every pixel,
  two 31 x 31 disk correlations, read at the keypoints.
- Descriptor: 256 point-pair tests (``_pattern``, the JAX package's numpy
  draw, so both packages test the same pairs) on the blurred image,
  rotated by each keypoint's angle, all keypoints in one batch; emitted as
  +-1/16 so that matching is one (N1, 256) x (256, N2) product with
  hamming = 128 (1 - sim), exact in float32.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from slam_tricks_tpu_torch.ops.image import (gaussian_blur, sample_bilinear,
                                             sobel)
from slam_tricks_tpu_torch.ops.nms import top_k_peaks
from slam_tricks_tpu_torch.solvers.common import set_full_precision

# the 16-point Bresenham circle of radius 3, in circular order: (dx, dy)
_CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
           (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
           (-2, -2), (-1, -3)]
_PATCH = 15          # descriptor and orientation half-window
_NBITS = 256


def _pattern(seed=7):
    """The BRIEF test pattern: (256, 2, 2) point pairs ~ N(0, patch / 5),
    clipped inside the patch (BRIEF's G-II recipe), float32 numpy."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, _PATCH / 5.0, size=(_NBITS, 2, 2))
    return np.clip(p, -(_PATCH - 2), _PATCH - 2).astype(np.float32)


_PATTERN = _pattern()


class OrbFeatures(NamedTuple):
    xy: torch.Tensor       # (N, 2) x, y pixel coordinates
    score: torch.Tensor    # (N,) Harris score (-inf in a padded slot)
    angle: torch.Tensor    # (N,) orientation, radians
    desc: torch.Tensor     # (N, 256) +-1/16 steered binary tests
    valid: torch.Tensor    # (N,) bool


def _contiguous9(masks):
    """(H, W): some 9 circularly consecutive masks of the 16 all hold."""
    m = torch.stack(masks).to(torch.int32)                   # (16, H, W)
    ext = torch.cat([torch.zeros_like(m[:1]), m, m[:8]])      # (25, H, W)
    c = torch.cumsum(ext, dim=0)
    return ((c[9:25] - c[0:16]) == 9).any(dim=0)


def _fast_mask(img, thresh):
    """FAST-9 corner mask: at least 9 contiguous circle pixels all brighter
    than the centre + thresh or all darker than the centre - thresh, at
    least _PATCH + 1 pixels inside the image (the shifts wrap, and the
    descriptor's patch must fit)."""
    shifted = [torch.roll(img, (-dy, -dx), dims=(0, 1)) for dx, dy in _CIRCLE]
    mask = (_contiguous9([s > img + thresh for s in shifted])
            | _contiguous9([s < img - thresh for s in shifted]))
    H, W = img.shape
    r = torch.arange(H, device=img.device)[:, None]
    c = torch.arange(W, device=img.device)[None, :]
    pad = _PATCH + 1
    inside = (r >= pad) & (r < H - pad) & (c >= pad) & (c < W - pad)
    return mask & inside


def _harris_response(img, blur=1.5, kappa=0.04):
    gx, gy = sobel(img)
    gxx = gaussian_blur(gx * gx, blur)
    gyy = gaussian_blur(gy * gy, blur)
    gxy = gaussian_blur(gx * gy, blur)
    return gxx * gyy - gxy * gxy - kappa * (gxx + gyy) ** 2


def _centroid_moments(img):
    """Each pixel's disk-patch intensity moments (m10, m01): one
    correlation with the two kernels x disk and y disk, zero padded."""
    set_full_precision()
    r = torch.arange(-_PATCH, _PATCH + 1, dtype=img.dtype, device=img.device)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    disk = (xx * xx + yy * yy <= _PATCH * _PATCH).to(img.dtype)
    kernels = torch.stack([xx * disk, yy * disk])[:, None]    # (2, 1, k, k)
    m = F.conv2d(img[None, None], kernels, padding=_PATCH)[0]
    return m[0], m[1]


def orb_detect(img, *, n=256, fast_thresh=0.04, nms_radius=4):
    """Up to n ORB features of img (H, W), grayscale in [0, 1]: a static
    shape, `valid` marks the real ones (a padded slot sits at (_PATCH + 1,
    _PATCH + 1) with a zero descriptor)."""
    dtype = img.dtype
    mask = _fast_mask(img, torch.as_tensor(fast_thresh, dtype=dtype,
                                           device=img.device))
    resp = torch.where(mask, _harris_response(img),
                       torch.full_like(img, float("-inf")))
    scores, rows, cols = top_k_peaks(resp, n, nms_radius)
    valid = torch.isfinite(scores)
    rows = torch.where(valid, rows, torch.full_like(rows, _PATCH + 1))
    cols = torch.where(valid, cols, torch.full_like(cols, _PATCH + 1))
    xy = torch.stack([cols, rows], dim=1).to(dtype)

    m10, m01 = _centroid_moments(img)
    angle = torch.atan2(m01[rows, cols], m10[rows, cols])

    # steered binary tests on the blurred image, every keypoint at once
    smooth = gaussian_blur(img, 2.0)
    pat = torch.as_tensor(_PATTERN, dtype=dtype, device=img.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    R = torch.stack([torch.stack([ca, -sa], dim=-1),
                     torch.stack([sa, ca], dim=-1)], dim=-2)  # (N, 2, 2)
    pts = torch.einsum("nij,btj->nbti", R, pat)               # (N, 256, 2, 2)
    va = sample_bilinear(smooth, xy[:, None, :] + pts[:, :, 0])
    vb = sample_bilinear(smooth, xy[:, None, :] + pts[:, :, 1])
    desc = torch.where(va < vb, 1.0, -1.0).to(dtype) / 16.0
    desc = desc * valid[:, None]
    return OrbFeatures(xy=xy, score=scores, angle=angle, desc=desc,
                       valid=valid)


def orb_match(f1: OrbFeatures, f2: OrbFeatures, *, ratio=0.9,
              max_hamming=64):
    """Mutual-best, Lowe-ratio Hamming matching through one product
    (hamming = 128 (1 - <d1, d2>) for the +-1/16 encoding). Argmax ties
    go to the first index, as in the JAX package. Returns (idx2 (N1,), ok
    (N1,))."""
    set_full_precision()
    sim = f1.desc @ f2.desc.T
    sim = torch.where(f2.valid[None, :], sim,
                      torch.full_like(sim, float("-inf")))
    best2 = torch.argmax(sim, dim=1)
    top2 = torch.topk(sim, 2, dim=1).values
    ham1 = 128.0 * (1.0 - top2[:, 0])
    ham2 = 128.0 * (1.0 - top2[:, 1])
    best1 = torch.argmax(sim, dim=0)
    mutual = best1[best2] == torch.arange(f1.desc.shape[0],
                                          device=sim.device)
    ok = (mutual & f1.valid & (ham1 <= max_hamming)
          & (ham1 < ratio * torch.clamp_min(ham2, 1e-6)))
    return best2, ok
