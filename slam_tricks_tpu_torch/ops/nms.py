"""Non-maximum suppression (port of ``slam_tricks_tpu/ops/nms.py``; st8
nms.hpp:10-81).

The JAX package's "SAME" ``reduce_window`` max becomes ``max_pool1d`` /
``max_pool2d`` with a (2r + 1) window, stride 1 and padding r: both pad
with -inf, so a pixel is a peak where it equals its window's maximum.
``top_k_peaks`` orders by a stable descending sort, so equal scores come
lowest flat index first, as ``jax.lax.top_k`` orders them: the -inf
padding of a plateau-free image gives the same slots on every device.
"""

import torch
import torch.nn.functional as F


def nms1d(x, radius):
    """Mask of the local maxima of x (N,) within +-radius (nms.hpp:10-38):
    x >= its window's maximum."""
    maxes = F.max_pool1d(x[None, None], 2 * radius + 1, stride=1,
                         padding=radius)[0, 0]
    return x >= maxes


def nms2d(img, radius, threshold=None):
    """Local-maximum mask of img (H, W) over (2r + 1)^2 windows
    (nms.hpp:40-81); with a threshold also img > threshold."""
    maxes = F.max_pool2d(img[None, None], 2 * radius + 1, stride=1,
                         padding=radius)[0, 0]
    mask = img >= maxes
    if threshold is not None:
        mask = mask & (img > threshold)
    return mask


def top_k_peaks(img, k, radius, threshold=float("-inf")):
    """NMS, then the k best scores: (scores (k,), rows (k,), cols (k,)),
    int64 indices; slots past the last peak above threshold have score
    -inf."""
    mask = nms2d(img, radius) & (img > threshold)
    scores = torch.where(mask, img, torch.full_like(img, float("-inf")))
    vals, idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    w = img.shape[1]
    return vals, idx // w, idx % w
