"""Panorama stitching (port of ``slam_tricks_tpu/pipelines/panorama.py``;
st11 panorama.cpp:19-153): corners, patch matching, RANSAC homographies,
chaining to the middle frame, and the canvas.

Harris corners, normalized patch descriptors matched all-pairs by one
product (or the ORB features of ``frontend.orb``), the batched ``ransac``
over a DLT homography, and inverse warping by bilinear gathers. The JAX
key becomes a ``torch.Generator`` (no common stream: the two packages draw
different subsets); ``stitch`` makes one from its seed. The chaining and
the canvas's corner arithmetic are host numpy, the JAX package's own.
"""

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.initialization.homography import (  # noqa: F401
    apply_h, homography_dlt)
from slam_tricks_tpu_torch.initialization.ransac import ransac
from slam_tricks_tpu_torch.ops.image import (gaussian_blur, sample_bilinear,
                                             sobel)
from slam_tricks_tpu_torch.ops.nms import top_k_peaks
from slam_tricks_tpu_torch.solvers.common import set_full_precision


def harris_corners(img, k=256, blur=1.5, kappa=0.04, nms_radius=6):
    """Harris response, NMS, the top k above 0.001 x its maximum. Returns
    (scores (k,), xy (k, 2)); an empty slot scores -inf."""
    gx, gy = sobel(img)
    gxx = gaussian_blur(gx * gx, blur)
    gyy = gaussian_blur(gy * gy, blur)
    gxy = gaussian_blur(gx * gy, blur)
    resp = gxx * gyy - gxy * gxy - kappa * (gxx + gyy) ** 2
    scores, rows, cols = top_k_peaks(resp, k, nms_radius,
                                     0.001 * torch.max(resp))
    return scores, torch.stack([cols, rows], dim=1).to(img.dtype)


def patch_descriptors(img, xy, patch=8):
    """Zero-mean, unit-norm (2 patch + 1)^2 patches about each xy (k, 2),
    sampled bilinearly: (k, (2 patch + 1)^2)."""
    r = torch.arange(-patch, patch + 1, dtype=img.dtype, device=img.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    offs = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=1)
    v = sample_bilinear(img, xy[:, None, :] + offs)
    v = v - torch.mean(v, dim=1, keepdim=True)
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1),
                               1e-6)[:, None]


def match_descriptors(d1, d2, ratio=0.9, valid1=None, valid2=None,
                      min_sim=0.6):
    """All-pairs NCC matching: mutual best, Lowe's ratio on the descriptor
    distance (d^2 = 2 - 2 sim for unit descriptors) and sim > min_sim.
    Argmax ties go to the first index, as in the JAX package. Returns
    (idx2 (k,), ok (k,)) for each row of d1."""
    set_full_precision()
    sim = d1 @ d2.T
    if valid2 is not None:
        sim = torch.where(valid2[None, :], sim, torch.full_like(sim, -1.0))
    best2 = torch.argmax(sim, dim=1)
    s_sorted = torch.topk(sim, 2, dim=1).values
    dist1 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * s_sorted[:, 0], 0.0))
    dist2 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * s_sorted[:, 1], 1e-12))
    best1 = torch.argmax(sim, dim=0)
    mutual = best1[best2] == torch.arange(d1.shape[0], device=sim.device)
    ok = (dist1 < ratio * dist2) & mutual & (s_sorted[:, 0] > min_sim)
    if valid1 is not None:
        ok = ok & valid1
    return best2, ok


def pairwise_homography(generator, img1, img2, n_corners=256, inlier_px=2.0,
                        features="harris"):
    """H mapping img1's coordinates to img2's, by corners and RANSAC (256
    hypotheses of 5 matches, a weighted DLT refit on the inliers).
    features: "harris" (NCC patches) or "orb" (steered binary descriptors,
    ``frontend.orb``: the reference's choice, panorama.cpp's ORB matches).
    generator: a ``torch.Generator`` on the images' device. Returns (H
    (3, 3), n_inliers)."""
    data = homography_matches(img1, img2, n_corners, features)
    res = ransac(generator, data, min_fit=homography_min_fit,
                 residual_sq=homography_residual_sq, refit=homography_refit,
                 subset_size=5, n_hyps=256, inlier_thresh_sq=inlier_px ** 2,
                 sample_weights=data["w"])
    return res.params.reshape(3, 3), res.n_inliers


def homography_matches(img1, img2, n_corners=256, features="harris"):
    """``pairwise_homography``'s RANSAC data: {"src": img1's corners (k,
    2), "dst": their matches in img2 (k, 2), "w": 1 where matched, else 0
    (k,)}."""
    if features == "orb":
        from slam_tricks_tpu_torch.frontend.orb import orb_detect, orb_match

        f1 = orb_detect(img1, n=n_corners)
        f2 = orb_detect(img2, n=n_corners)
        m_idx, m_ok = orb_match(f1, f2)
        xy1, xy2 = f1.xy, f2.xy
    else:
        s1, xy1 = harris_corners(img1, n_corners)
        s2, xy2 = harris_corners(img2, n_corners)
        m_idx, m_ok = match_descriptors(
            patch_descriptors(img1, xy1), patch_descriptors(img2, xy2),
            valid1=torch.isfinite(s1), valid2=torch.isfinite(s2))
    return {"src": xy1, "dst": xy2[m_idx], "w": m_ok.to(img1.dtype)}


def homography_min_fit(d):
    """``pairwise_homography``'s minimal fit: the DLT of a subset, flat."""
    return homography_dlt(d["src"], d["dst"], d["w"]).reshape(-1)


def homography_residual_sq(params, d):
    """Squared transfer errors of the matches (inf where unmatched)."""
    pred = apply_h(params.reshape(3, 3), d["src"])
    r2 = torch.sum((pred - d["dst"]) ** 2, dim=1)
    return torch.where(d["w"] > 0, r2, torch.full_like(r2, float("inf")))


def homography_refit(d, weights):
    """The DLT weighted by the inlier mask times the match mask, flat."""
    return homography_dlt(d["src"], d["dst"], weights * d["w"]).reshape(-1)


def chain_to_middle(Hs_pairwise):
    """The pairwise homographies H_i->i+1 chained to the middle frame
    (panorama.cpp:106-118), numpy. Returns the list of H_i->mid."""
    n = len(Hs_pairwise) + 1
    mid = n // 2
    Hs = [None] * n
    Hs[mid] = np.eye(3)
    for i in range(mid - 1, -1, -1):
        Hs[i] = Hs[i + 1] @ np.asarray(Hs_pairwise[i])
    for i in range(mid + 1, n):
        Hs[i] = Hs[i - 1] @ np.linalg.inv(np.asarray(Hs_pairwise[i - 1]))
    return Hs


def compose_panorama(images, Hs_to_mid, device=None):
    """Every image inverse-warped onto one canvas (the bias translation
    and warp of panorama.cpp:120-152), later images over earlier ones,
    float32 on `device` (the card unless the caller names another).
    Returns (canvas (Hc, Wc), covered (Hc, Wc) bool)."""
    dev = resolve(device)
    corners = []
    for img, H in zip(images, Hs_to_mid):
        h, w = img.shape[:2]
        pts = np.array([[0, 0], [w, 0], [0, h], [w, h]], float)
        ph = np.concatenate([pts, np.ones((4, 1))], 1) @ np.asarray(H).T
        corners.append(ph[:, :2] / ph[:, 2:])
    allc = np.concatenate(corners)
    lo = np.floor(allc.min(axis=0)).astype(int)
    hi = np.ceil(allc.max(axis=0)).astype(int)
    W = int(hi[0] - lo[0])
    Hh = int(hi[1] - lo[1])
    canvas = torch.zeros((Hh, W), dtype=torch.float32, device=dev)
    weight = torch.zeros((Hh, W), dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(torch.arange(Hh, device=dev) + int(lo[1]),
                            torch.arange(W, device=dev) + int(lo[0]),
                            indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).to(torch.float32).reshape(-1, 2)
    for img, H in zip(images, Hs_to_mid):
        Hinv = torch.as_tensor(np.linalg.inv(np.asarray(H)),
                               dtype=torch.float32, device=dev)
        src_xy = apply_h(Hinv, grid).reshape(Hh, W, 2)
        h, w = img.shape
        inb = ((src_xy[..., 0] >= 0) & (src_xy[..., 0] <= w - 1)
               & (src_xy[..., 1] >= 0) & (src_xy[..., 1] <= h - 1))
        vals = sample_bilinear(torch.as_tensor(img, dtype=torch.float32,
                                               device=dev), src_xy)
        canvas = torch.where(inb, canvas * (weight > 0) * 0.0 + vals, canvas)
        weight = torch.where(inb, 1.0, weight)
    return canvas, weight > 0


def stitch(images, seed=0, device=None, features="harris"):
    """The whole pipeline on `device` (the card unless the caller names
    another): consecutive pairwise homographies (``pairwise_homography``
    with `features`, one generator made from `seed`), chained to the
    middle, composed. Returns (canvas, covered)."""
    dev = resolve(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    Hs_pair = []
    for a, b in zip(images[:-1], images[1:]):
        H, _ = pairwise_homography(
            generator, torch.as_tensor(a, dtype=torch.float32, device=dev),
            torch.as_tensor(b, dtype=torch.float32, device=dev),
            features=features)
        Hs_pair.append(H.cpu().numpy())
    return compose_panorama(images, chain_to_middle(Hs_pair), device=dev)
