"""Chessboard corner detection (port of
``slam_tricks_tpu/frontend/chessboard.py``; st10-chessCorner, "Automatic
Camera and Range Sensor Calibration using a single Shot"), reference
detector.cpp:11-110:

 1. corner likelihood: prototype-kernel correlations composed with min and
    max (compute_likehood :211-247)            -> ``corner_likelihood``
 2. candidates: NMS and a threshold (findCorners :249-265)
                                               -> ``ops.nms.top_k_peaks``
 3. orientations: a gradient-orientation histogram and its modes
    (verifyCorners :267-380, meanShift helper.cpp:179-205)
                                               -> ``estimate_orientations``,
                                                  ``verify_corners_meanshift``
 4. subpixel refinement (refineCorners :381-400) and edge directions
    (:403-455)                                 -> ``refine_corners_subpixel``,
                                                  ``refine_edge_directions``
 5. board growth (:469-824): a greedy sequential search on the host in
    numpy, ``grow_chessboards`` (the JAX package's own code).

Stages 1-4 work on a fixed budget of K candidates, invalid slots carrying
score -inf. Where the JAX package maps one candidate's window with
``vmap``, the port gathers all K windows at once ((K, n, n) index grids)
and reduces over the window axes. ``_mod`` is ``jnp.mod``'s remainder
(``fmod``, moved to the divisor's sign), so angles fall in the same
histogram bins as there; the hard histogram is a one-hot sum, no float
atomics.
"""

import math

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.ops.image import conv2d, sobel
from slam_tricks_tpu_torch.ops.nms import top_k_peaks


def _mod(x, y):
    """x mod y with the sign of y, computed as ``jnp.mod`` does."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _windows(img, xy, window):
    """The (K, n, n) integer grids (ys, xs) of the windows of half-width
    `window` about each rounded point xy (K, 2), clipped inside img, and
    their centres (y0 (K,), x0 (K,))."""
    H, W = img.shape
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), window,
                     W - window - 1)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), window,
                     H - window - 1)
    r = torch.arange(-window, window + 1, device=img.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return y0[:, None, None] + dy, x0[:, None, None] + dx, y0, x0


def _prototype_kernels(radius, angles, dtype=torch.float32, device=None):
    """Four quadrant kernels (A, B an opposing pair; C, D the other) of a
    corner prototype at the given axis angles (prototype.h:9-24), rounded
    to float32 as the JAX package's are, on `device` (the card unless the
    caller names another)."""
    n = 2 * radius + 1
    ys, xs = np.meshgrid(np.arange(n) - radius, np.arange(n) - radius,
                         indexing="ij")
    r = np.sqrt(xs ** 2 + ys ** 2)
    weight = np.exp(-0.5 * (r / (radius / 2.0)) ** 2)
    a0, a1 = angles
    n0 = np.array([-math.sin(a0), math.cos(a0)])
    n1 = np.array([-math.sin(a1), math.cos(a1)])
    s0 = xs * n0[1] + ys * n0[0]
    s1 = xs * n1[1] + ys * n1[0]
    kA = weight * ((s0 > 0.1) & (s1 > 0.1))
    kB = weight * ((s0 < -0.1) & (s1 < -0.1))
    kC = weight * ((s0 > 0.1) & (s1 < -0.1))
    kD = weight * ((s0 < -0.1) & (s1 > 0.1))
    return [torch.as_tensor((k / max(k.sum(), 1e-9)).astype(np.float32),
                            dtype=dtype, device=resolve(device))
            for k in (kA, kB, kC, kD)]


def corner_likelihood(img, radius=4):
    """Corner likelihood of img (H, W) in [0, 1] from two prototypes (axis
    aligned and diagonal), composed by min and max as the paper does
    (detector.cpp:211-247)."""
    like = None
    for angles in ((0.0, math.pi / 2), (math.pi / 4, 3 * math.pi / 4)):
        fA, fB, fC, fD = (conv2d(img, k) for k in _prototype_kernels(
            radius, angles, img.dtype, img.device))
        mu = 0.25 * (fA + fB + fC + fD)
        s1 = torch.minimum(torch.minimum(fA, fB) - mu,
                           mu - torch.maximum(fC, fD))
        s2 = torch.minimum(mu - torch.maximum(fA, fB),
                           torch.minimum(fC, fD) - mu)
        s = torch.maximum(s1, s2)
        like = s if like is None else torch.maximum(like, s)
    return torch.clamp_min(like, 0.0)


def corner_likelihood_multiscale(img, radii=(4, 8, 12)):
    """The likelihood's maximum over prototype radii (the paper's 4, 8 and
    12; the reference fixes one, PROTO_HWS = 10, detector.h:68-69)."""
    like = None
    for r in radii:
        s = corner_likelihood(img, r)
        like = s if like is None else torch.maximum(like, s)
    return like


def detect_corners(img, k=256, radius=4, nms_radius=5, rel_threshold=0.03,
                   radii=None):
    """Stages 1 and 2: likelihood (multi-scale with radii), NMS, the top k
    above rel_threshold x its maximum. Returns (scores (k,), xy (k, 2)
    float pixel coordinates); a slot below the threshold scores -inf."""
    like = (corner_likelihood_multiscale(img, radii) if radii is not None
            else corner_likelihood(img, radius))
    scores, rows, cols = top_k_peaks(like, k, nms_radius,
                                     rel_threshold * torch.max(like))
    return scores, torch.stack([cols, rows], dim=1).to(img.dtype)


def refine_corners_subpixel(img, xy, window=10):
    """Stage 4: each corner c solves (sum g g^T) c = sum (g g^T) p over its
    window, the gradient-orthogonality normal equations (refineCorners
    detector.cpp:381-400). Returns (k, 2); a point whose system is
    degenerate or whose solution leaves the window stays."""
    gx, gy = sobel(img)
    ys, xs, _, _ = _windows(img, xy, window)
    gxx = gx[ys, xs]
    gyy = gy[ys, xs]
    px = xs.to(img.dtype)
    py = ys.to(img.dtype)
    dims = (1, 2)
    a = torch.sum(gxx * gxx, dim=dims)
    b = torch.sum(gxx * gyy, dim=dims)
    c = torch.sum(gyy * gyy, dim=dims)
    bx = torch.sum((gxx * gxx) * px + (gxx * gyy) * py, dim=dims)
    by = torch.sum((gxx * gyy) * px + (gyy * gyy) * py, dim=dims)
    det = a * c - b * b
    ok = det > 1e-8
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    refined = torch.stack([inv_det * (c * bx - b * by),
                           inv_det * (a * by - b * bx)], dim=1)
    good = ok & (torch.max(torch.abs(refined - xy), dim=1).values < window)
    return torch.where(good[:, None], refined, xy)


def estimate_orientations(img, xy, window=10, n_bins=32):
    """Stage 3: each candidate's soft gradient-orientation histogram and
    its two strongest modes at least pi / 8 apart. Returns (angles (k, 2)
    edge angles in [0, pi), mode strengths (k, 2))."""
    gx, gy = sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = _mod(torch.atan2(gy, gx), math.pi)
    ys, xs, _, _ = _windows(img, xy, window)
    K = xy.shape[0]
    m = mag[ys, xs].reshape(K, -1)
    a = ang[ys, xs].reshape(K, -1)
    bin_centers = (torch.arange(n_bins, dtype=img.dtype, device=img.device)
                   * (math.pi / n_bins))
    # soft circular binning (in place of meanShift, helper.cpp:179-205)
    d = a[:, :, None] - bin_centers
    d = torch.abs(_mod(d + math.pi / 2, math.pi) - math.pi / 2)
    w = torch.exp(-0.5 * (d / (math.pi / n_bins)) ** 2)
    hist = torch.sum(m[:, :, None] * w, dim=1)                # (K, n_bins)
    i1 = torch.argmax(hist, dim=1)
    sep = torch.abs(_mod(bin_centers - bin_centers[i1][:, None] + math.pi / 2,
                         math.pi) - math.pi / 2)
    masked = torch.where(sep > math.pi / 8, hist,
                         torch.full_like(hist, float("-inf")))
    i2 = torch.argmax(masked, dim=1)
    rows = torch.arange(K, device=img.device)
    return (torch.stack([bin_centers[i1], bin_centers[i2]], dim=1),
            torch.stack([hist[rows, i1], masked[rows, i2]], dim=1))


def verify_corners(img, xy, scores, window=10, min_mode_ratio=0.3,
                   min_separation=math.pi / 4):
    """Stage 3b: keep candidates whose histogram shows two strong modes at
    least min_separation apart (verifyCorners, detector.cpp:267-380);
    scores with the rejected ones set to -inf. At small squares the
    window under-resolves the modes: take window ~ half a square."""
    angles, strength = estimate_orientations(img, xy, window=window)
    sep = torch.abs(_mod(angles[:, 0] - angles[:, 1] + math.pi / 2, math.pi)
                    - math.pi / 2)
    ratio = strength[:, 1] / torch.clamp_min(strength[:, 0], 1e-9)
    ok = (ratio > min_mode_ratio) & (sep > min_separation)
    return torch.where(ok, scores, torch.full_like(scores, float("-inf")))


def _circular_gauss_taps(hist):
    """Circular 5-tap smoothing [.1, .2, .4, .2, .1] of (..., 32)
    histograms (the reference's gaussFilter, helper.cpp:165-177)."""
    taps = (0.1, 0.2, 0.4, 0.2, 0.1)
    return sum(t * torch.roll(hist, k, dims=-1)
               for t, k in zip(taps, (-2, -1, 0, 1, 2)))


def mean_shift_modes(hist):
    """Circular mean-shift bimodal mode finding on (..., 32) histograms,
    the reference's meanShift (helper.cpp:179-253): seeds at bins 6, 16 and
    26, 10 iterations of half-window 4 and 10 of half-window 2, a snap to
    the local peak, the two closest seeds merged keeping the stronger.
    Returns (i1, i2) int64 bins (...)."""
    n = hist.shape[-1]
    dtype, device = hist.dtype, hist.device
    offs4 = torch.arange(-4, 5, device=device)
    offs2 = torch.arange(-2, 3, device=device)

    def at(i):
        return torch.gather(hist, -1, i[..., None])[..., 0]

    def shift(idx, offs):
        c = torch.remainder(torch.round(idx).to(torch.int64), n)
        vals = torch.gather(hist, -1, torch.remainder(c[..., None] + offs, n))
        return idx + (torch.sum(offs.to(dtype) * vals, dim=-1)
                      / torch.clamp_min(torch.sum(vals, dim=-1), 1e-12))

    def run(start):
        idx = torch.full(hist.shape[:-1], start, dtype=dtype, device=device)
        for _ in range(10):
            idx = shift(idx, offs4)
        for _ in range(10):
            idx = shift(idx, offs2)
        # snap: the better of floor and round, then the best of its
        # 3-neighbourhood
        lower = torch.remainder(torch.floor(idx).to(torch.int64), n)
        top = torch.remainder(torch.round(idx).to(torch.int64), n)
        mid = torch.where(at(lower) > at(top), lower, top)
        lo = torch.remainder(mid - 1, n)
        hi = torch.remainder(mid + 1, n)
        return torch.where(at(lo) >= torch.maximum(at(mid), at(hi)), lo,
                           torch.where(at(mid) >= at(hi), mid, hi))

    i1, i2, i3 = run(6.0), run(16.0), run(26.0)

    def cdist(a, b):
        d = torch.abs(a - b)
        return torch.minimum(d, n - d)

    def pick(a, b):
        return torch.where(at(a) > at(b), a, b)

    d12, d13, d23 = cdist(i1, i2), cdist(i1, i3), cdist(i2, i3)
    dmin = torch.minimum(torch.minimum(d12, d13), d23)
    m1 = torch.where(d12 == dmin, i3, torch.where(d13 == dmin, i2, i1))
    m2 = torch.where(d12 == dmin, pick(i1, i2),
                     torch.where(d13 == dmin, pick(i1, i3), pick(i2, i3)))
    return m1, m2


def _sector_prototype(radius, a1, a2, dtype):
    """Angular-sector corner prototype quadrants (prototype.cpp:5-37) for
    each pair of angles a1, a2 (K,): pixels binned by polar angle into
    [a1, a2) -> A, [a2, a1 + pi) -> C, [a1 + pi, a2 + pi) -> B,
    [a2 + pi, a1) -> D, Gaussian radial weight sigma = radius / 2, the
    centre 0. Returns four (K, n, n)."""
    n = 2 * radius + 1
    g = torch.arange(n, device=a1.device) - radius
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    r = torch.sqrt((xs ** 2 + ys ** 2).to(dtype))
    wgt = torch.exp(-0.5 * (r / (radius / 2.0)) ** 2)
    wgt[radius, radius] = 0.0
    ang = torch.atan2(ys.to(dtype), xs.to(dtype))
    two_pi = 2 * math.pi

    def in_range(lo, hi):
        return (_mod(ang - lo[:, None, None], two_pi)
                < _mod(hi - lo, two_pi)[:, None, None])

    return (wgt * in_range(a1, a2), wgt * in_range(a1 + math.pi, a2 + math.pi),
            wgt * in_range(a2, a1 + math.pi), wgt * in_range(a2 + math.pi, a1))


def _sobel_mag(patch):
    """Gradient magnitude of (..., n, n) patches by a rolled 3x3 Sobel (as
    cv2.Sobel with ksize 3 up to the border rows, which the prototype's
    Gaussian weight suppresses)."""
    def sh(dy, dx):
        return torch.roll(torch.roll(patch, dy, dims=-2), dx, dims=-1)

    gx = ((sh(0, -1) - sh(0, 1)) * 2 + (sh(-1, -1) - sh(-1, 1))
          + (sh(1, -1) - sh(1, 1)))
    gy = ((sh(-1, 0) - sh(1, 0)) * 2 + (sh(-1, -1) - sh(1, -1))
          + (sh(-1, 1) - sh(1, 1)))
    return torch.sqrt(gx * gx + gy * gy)


def verify_corners_meanshift(img, xy, scores, like=None, window=10,
                             rel_threshold=0.25):
    """Stage 3 as the reference does it (verifyCorners
    detector.cpp:267-380): each candidate's 32-bin hard gradient-orientation
    histogram, circular smoothing, mean-shift modes, the gate (modes more
    than 10 of 32 bins apart, their values within 70%), then the score

        likelihood(pt) x <|grad| patch, the two-mode sector prototype's
                          expected |grad|> / (norms),

    kept above rel_threshold x the best (the reference's default 0.4,
    detector.h:68). Returns (scores (k,), angles (k, 2) edge angles in
    [0, pi)); a rejected slot scores -inf."""
    gx, gy = sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = _mod(torch.atan2(gy, gx), math.pi)
    if like is None:
        like = corner_likelihood(img)
    dtype = img.dtype
    n_bins = 32
    bin_size = math.pi / n_bins
    ys, xs, y0, x0 = _windows(img, xy, window)
    K = xy.shape[0]
    m = mag[ys, xs]                                           # (K, n, n)
    a = ang[ys, xs]
    bins = torch.clamp((a / bin_size).to(torch.int64), 0, n_bins - 1)
    onehot = (bins.reshape(K, -1, 1)
              == torch.arange(n_bins, device=img.device)).to(dtype)
    hist = torch.sum(onehot * m.reshape(K, -1, 1), dim=1)     # (K, 32)
    hist = _circular_gauss_taps(hist)
    i1, i2 = mean_shift_modes(hist)
    lo = torch.minimum(i1, i2)
    hi = torch.maximum(i1, i2)
    a1 = lo.to(dtype) / (n_bins - 1.0) * math.pi
    a2 = hi.to(dtype) / (n_bins - 1.0) * math.pi
    rows = torch.arange(K, device=img.device)
    v1, v2 = hist[rows, i1], hist[rows, i2]
    dis = torch.abs(i1 - i2)
    dis = torch.where(dis > n_bins // 2, n_bins - dis, dis)
    gate = (dis > 10) & (torch.abs(v1 - v2) < torch.maximum(v1, v2) * 0.7)

    # prototype-gradient correlation
    A, B, C, D = _sector_prototype(window, a1, a2, dtype)
    exp_grad = torch.maximum(torch.maximum(_sobel_mag(A), _sobel_mag(B)),
                             torch.maximum(_sobel_mag(C), _sobel_mag(D)))
    num = torch.sum(m * exp_grad, dim=(1, 2))
    den = (torch.sqrt(torch.sum(m * m, dim=(1, 2)))
           * torch.sqrt(torch.sum(exp_grad ** 2, dim=(1, 2))))
    score = like[y0, x0] * (num / torch.clamp_min(den, 1e-12))
    ok = gate & torch.isfinite(scores)
    scores_new = torch.where(ok, score, torch.full_like(score, float("-inf")))
    finite = torch.isfinite(scores_new)
    smax = torch.max(torch.where(finite, scores_new,
                                 torch.zeros_like(scores_new)))
    scores_new = torch.where(scores_new > rel_threshold * smax, scores_new,
                             torch.full_like(scores_new, float("-inf")))
    return scores_new, torch.stack([a1, a2], dim=1)


def _smallest_evec_angle(a, b, c, fallback):
    """Angle in [0, pi) of the smallest eigenvector of [[a, b], [b, c]]
    (the edge direction), or `fallback` where the selection was empty."""
    tr = a + c
    det = a * c - b * b
    lam_min = tr / 2 - torch.sqrt(torch.clamp_min(tr * tr / 4 - det, 0.0))
    v1 = torch.stack([b, lam_min - a], dim=-1)
    v2 = torch.stack([lam_min - c, b], dim=-1)
    v = torch.where((torch.sum(v1 * v1, dim=-1)
                     > torch.sum(v2 * v2, dim=-1))[..., None], v1, v2)
    ok = torch.sum(v * v, dim=-1) > 1e-20
    angle = _mod(torch.atan2(v[..., 1], v[..., 0]), math.pi)
    return torch.where(ok, angle, fallback)


def refine_edge_directions(img, xy, angles, window=5, rounds=2):
    """Stage 4b (detector.cpp:403-455): each corner's two edge directions
    re-estimated from the gradients of its window. Gradients nearly
    orthogonal to an edge's direction (|cos| < 0.25 after normalization)
    are assigned to it; the new direction is the null direction of their
    second-moment matrix (the reference's N x 2 SVD, here the closed-form
    smallest eigenvector of the 2 x 2), `rounds` times. Returns (k, 2) in
    [0, pi)."""
    gx, gy = sobel(img)
    ys, xs, _, _ = _windows(img, xy, window)
    K = xy.shape[0]
    g1 = gx[ys, xs].reshape(K, -1)
    g2 = gy[ys, xs].reshape(K, -1)
    norm = torch.sqrt(g1 * g1 + g2 * g2)
    n1 = g1 / torch.clamp_min(norm, 1e-12)
    n2 = g2 / torch.clamp_min(norm, 1e-12)

    def refine_one(a_cur):
        c, s = torch.cos(a_cur)[:, None], torch.sin(a_cur)[:, None]
        sel = (torch.abs(c * n1 + s * n2) < 0.25) & (norm > 1e-9)
        w = sel.to(img.dtype)
        return _smallest_evec_angle(torch.sum(w * g1 * g1, dim=1),
                                    torch.sum(w * g1 * g2, dim=1),
                                    torch.sum(w * g2 * g2, dim=1), a_cur)

    out = angles
    for _ in range(rounds):
        out = torch.stack([refine_one(out[:, 0]), refine_one(out[:, 1])],
                          dim=1)
    return out


def detect_chessboard(img, k=256, radii=(4, 8, 12), nms_radius=5,
                      hist_window=10, refine_window=5, max_boards=4,
                      device=None):
    """The whole detector (Detector::solve detector.cpp:11-110): multi-scale
    likelihood, NMS top-k, mean-shift verification with the prototype
    score, subpixel refinement, edge directions, then the board growth on
    the host. img: (H, W) array or tensor, moved to `device` (the card
    unless the caller names another). Returns (boards, xy_refined, scores,
    angles): boards a list of (rows, cols) int64 numpy index grids into
    xy_refined, the best energy first."""
    imgt = torch.as_tensor(img, device=resolve(device))
    like = corner_likelihood_multiscale(imgt, radii)
    s, rows, cols = top_k_peaks(like, k, nms_radius, 0.03 * torch.max(like))
    xy = torch.stack([cols, rows], dim=1).to(imgt.dtype)
    scores, angles = verify_corners_meanshift(imgt, xy, s, like,
                                              window=hist_window)
    xy_ref = refine_corners_subpixel(imgt, xy, window=refine_window)
    angles = refine_edge_directions(imgt, xy_ref, angles,
                                    window=refine_window)
    boards = grow_chessboards(xy_ref.cpu().numpy(), angles.cpu().numpy(),
                              scores.cpu().numpy(), max_boards=max_boards)
    return boards, xy_ref, scores, angles


def board_energy(P):
    """Chessboard structure energy of a grid of corners P (R, C, 2), numpy:

        E = num * (max_triple ||c_i + c_k - 2 c_j|| / ||c_i - c_k||  -  1)

    over all consecutive triples along rows and columns, the reference's
    chessBoardEnergy (detector.cpp:713-744). More corners and straighter
    lines both lower E. Returns (E, the worst triple's ratio)."""
    R, C = P.shape[:2]
    num = R * C
    worst = 0.0
    for A in (P, P.transpose(1, 0, 2)):          # rows, then columns
        if A.shape[1] < 3:
            continue
        ci, cj, ck = A[:, :-2], A[:, 1:-1], A[:, 2:]
        err = np.linalg.norm(ci + ck - 2 * cj, axis=2)
        den = np.linalg.norm(ci - ck, axis=2) + 1e-12
        worst = max(worst, float(np.max(err / den)))
    return num * (worst - 1.0), worst


def grow_chessboards(xy, angles, scores, max_boards=4, dist_factor=1.6,
                     init_straightness=0.3):
    """Stage 5 on the host, numpy: energy-gated growth of chessboard grids,
    the reference's seed, grow and energy steps (initChessBoard
    detector.cpp:602-673, growChessBoard :746-808 with the 0.85
    extrapolation of predictCorners :810-815, the chessBoardEnergy gate
    :713-744, the energy-sorted dedup of solveMutiCB :481-560).

    Returns a list of (rows, cols) index grids into `xy`, the best energy
    first. A sequential pointer chase: it stays on the host, stages 1-4
    run on the device."""
    xy = np.asarray(xy)
    scores = np.asarray(scores)
    idxs = np.nonzero(np.isfinite(scores))[0]
    if len(idxs) < 9:
        return []
    pts = xy[idxs]
    M = len(idxs)

    def nearest_in_dir(p, direction, cos_thresh=0.85):
        d = pts - p
        dist = np.linalg.norm(d, axis=1) + 1e-9
        cosang = (d @ direction) / dist
        cand = np.where((cosang > cos_thresh) & (dist > 1e-6), dist, np.inf)
        j = int(np.argmin(cand))
        return j if np.isfinite(cand[j]) else -1

    def nearest_to(p, max_dist):
        dist = np.linalg.norm(pts - p, axis=1)
        j = int(np.argmin(dist))
        return j if dist[j] < max_dist else -1

    def init_board(seed):
        """A 3x3 seed board about `seed` (initChessBoard :602-673)."""
        p = pts[seed]
        d = np.linalg.norm(pts - p, axis=1)
        d[seed] = np.inf
        d[d < 1e-6] = np.inf          # zero-distance duplicates
        nn1 = int(np.argmin(d))
        if not np.isfinite(d[nn1]):
            return None
        dir1 = (pts[nn1] - p) / d[nn1]
        # the second axis: the nearest neighbour not collinear with dir1
        dd = pts - p
        dist = np.linalg.norm(dd, axis=1) + 1e-9
        cosang = np.abs((dd @ dir1) / dist)
        cand = np.where((cosang < 0.6) & (dist > 1e-6), dist, np.inf)
        nn2 = int(np.argmin(cand))
        if not np.isfinite(cand[nn2]):
            return None
        dir2 = (pts[nn2] - p) / dist[nn2]
        step = 0.5 * (d[nn1] + dist[nn2])

        grid = -np.ones((3, 3), np.int64)
        grid[1, 1] = seed
        for (r, c), dv in (((1, 2), dir1), ((1, 0), -dir1),
                           ((2, 1), dir2), ((0, 1), -dir2)):
            j = nearest_in_dir(p, dv)
            if j < 0 or np.linalg.norm(pts[j] - p) > dist_factor * step:
                return None
            grid[r, c] = j
        # the diagonal corners by cross prediction (p + d_row + d_col)
        for (r, c), (a, b) in (((0, 0), ((1, 0), (0, 1))),
                               ((0, 2), ((1, 2), (0, 1))),
                               ((2, 0), ((1, 0), (2, 1))),
                               ((2, 2), ((1, 2), (2, 1)))):
            pred = pts[grid[a]] + pts[grid[b]] - p
            j = nearest_to(pred, 0.6 * step)
            if j < 0:
                return None
            grid[r, c] = j
        if len(set(grid.ravel().tolist())) != 9:
            return None
        e, straight = board_energy(pts[grid])
        if straight > init_straightness:
            return None
        return grid

    def grow_once(grid):
        """All 4 directions tried; the grown grid of the lowest energy if
        some growth lowers it (growChessBoard :746-808), else None."""
        e0, _ = board_energy(pts[grid])
        best = None
        taken = set(grid.ravel().tolist())
        for axis, side in ((0, 0), (0, -1), (1, 0), (1, -1)):
            A = grid if axis == 0 else grid.T
            if A.shape[0] < 2:
                continue
            edge, inner = (A[0], A[1]) if side == 0 else (A[-1], A[-2])
            # the 0.85 extrapolation (predictCorners :810-815); the
            # acceptance radius is each corner's own spacing, so strong
            # perspective foreshortening does not kill whole rows
            pred = pts[edge] + 0.85 * (pts[edge] - pts[inner])
            spacing = np.linalg.norm(pts[edge] - pts[inner], axis=1)
            new = []
            ok = True
            for q, sp in zip(pred, spacing):
                j = nearest_to(q, 0.5 * sp)
                if j < 0 or j in taken or j in new:
                    ok = False
                    break
                new.append(j)
            if not ok:
                continue
            row = np.asarray(new)[None, :]
            B = np.concatenate([row, A] if side == 0 else [A, row], axis=0)
            cand = B if axis == 0 else B.T
            e1, _ = board_energy(pts[cand])
            if e1 < e0 and (best is None or e1 < best[0]):
                best = (e1, cand)
        return best

    order = np.argsort(-scores[idxs])
    proposals = []
    seeded = np.zeros(M, bool)
    for seed in order:
        if seeded[seed]:
            continue
        grid = init_board(seed)
        if grid is None:
            continue
        while True:
            grown = grow_once(grid)
            if grown is None:
                break
            grid = grown[1]
        seeded[grid.ravel()] = True
        proposals.append((board_energy(pts[grid])[0], grid))

    # the energy-sorted dedup of overlapping boards (solveMutiCB :481-560)
    proposals.sort(key=lambda t: t[0])
    boards, claimed = [], np.zeros(M, bool)
    for e, grid in proposals:
        if len(boards) >= max_boards:
            break
        flat = grid.ravel()
        if claimed[flat].mean() > 0.25:
            continue
        claimed[flat] = True
        boards.append(idxs[grid])
    return boards
