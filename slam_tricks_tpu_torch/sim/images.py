"""Synthetic test images for the front end, in numpy and scipy (no cv2),
as float32 arrays in [0, 1] made from a seed: the JAX package's test
recipes (a blurred block texture and its sub-pixel shift, a rendered
chessboard with its interior corners), random filled polygons with hard
corners for FAST, and a rotation about the centre with OpenCV's
``getRotationMatrix2D`` / ``warpAffine`` conventions, done by
``scipy.ndimage``. Host code: tensors are made by the caller.
"""

import numpy as np


def textured_image(h=120, w=160, seed=0):
    """A smooth random texture with enough gradient structure for LK and
    Harris: 8 x 8 blocks of N(0, 1), Gaussian-blurred (sigma 2),
    normalized to [0, 1]."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    base = rng.normal(size=(h // 8 + 2, w // 8 + 2))
    img = np.kron(base, np.ones((8, 8)))[:h, :w]
    img = gaussian_filter(img, 2.0)
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def shift_image(img, dx, dy):
    """img moved by (dx, dy) pixels, cubic spline interpolation, edges
    extended: content at x lands at x + dx."""
    from scipy.ndimage import map_coordinates

    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w]
    return map_coordinates(img, [yy - dy, xx - dx], order=3,
                           mode="nearest").astype(np.float32)


def _fill_polygon(img, pts, value):
    """Set the pixels of img whose integer centres lie inside the polygon
    pts (k, 2) (x, y) to value, by the even-odd crossing rule."""
    H, W = img.shape
    x0, y0 = np.maximum(np.floor(pts.min(axis=0)).astype(int), 0)
    x1, y1 = np.minimum(np.ceil(pts.max(axis=0)).astype(int), [W - 1, H - 1])
    if x1 < x0 or y1 < y0:
        return
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    inside = np.zeros(yy.shape, bool)
    for (xa, ya), (xb, yb) in zip(pts, np.roll(pts, -1, axis=0)):
        crosses = (ya > yy) != (yb > yy)
        with np.errstate(divide="ignore", invalid="ignore"):
            xc = xa + (yy - ya) * (xb - xa) / (yb - ya)
        inside ^= crosses & (xx < xc)
    img[y0:y1 + 1, x0:x1 + 1][inside] = value


def polygon_image(seed=0, H=240, W=320, n_shapes=50):
    """Random filled polygons (3 to 5 vertices, radii 6-22 px) of random
    grey levels on 0.5, blurred (sigma 1): hard corners that FAST finds
    again after a rotation."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    img = np.full((H, W), 0.5, np.float32)
    for _ in range(n_shapes):
        c = rng.uniform([30, 30], [W - 30, H - 30])
        k = rng.integers(3, 6)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(6, 22, k)
        pts = np.round(c[None] + np.stack([rad * np.cos(ang),
                                           rad * np.sin(ang)], 1))
        _fill_polygon(img, pts, float(rng.uniform(0, 1)))
    img = gaussian_filter(img, 1.0)
    return np.clip(img, 0, 1).astype(np.float32)


def rotation_matrix(center, deg):
    """OpenCV's getRotationMatrix2D(center, deg, 1): the (2, 3) map of a
    source pixel (x, y) to its place in the rotated image."""
    a = np.deg2rad(deg)
    al, be = np.cos(a), np.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]])


def rotate_image(img, deg):
    """img rotated by deg about its centre (W / 2, H / 2), bilinear, zero
    outside (warpAffine's defaults). Returns (rotated, M (2, 3))."""
    from scipy.ndimage import map_coordinates

    H, W = img.shape
    M = rotation_matrix((W / 2, H / 2), deg)
    Minv = np.linalg.inv(np.vstack([M, [0.0, 0.0, 1.0]]))[:2]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    xs = Minv[0, 0] * xx + Minv[0, 1] * yy + Minv[0, 2]
    ys = Minv[1, 0] * xx + Minv[1, 1] * yy + Minv[1, 2]
    out = map_coordinates(np.asarray(img, np.float64), [ys, xs], order=1,
                          mode="constant", cval=0.0)
    return out.astype(np.float32), M


def render_chessboard(rows=4, cols=5, square_px=24, margin=30, angle=0.1,
                      noise=0.0, seed=11, shape=None):
    """A rotated chessboard of rows x cols interior corners ((rows + 1) x
    (cols + 1) squares of square_px) on grey 0.5, with N(0, noise) noise
    from `seed`; the image square of side 2 margin + square_px (max(rows,
    cols) + 1) + 40 unless shape (H, W) is given. Returns (img float32,
    the interior corners (N, 2) float64 (x, y))."""
    if shape is None:
        H = W = 2 * margin + square_px * (max(rows, cols) + 1) + 40
    else:
        H, W = shape
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    c, s = np.cos(angle), np.sin(angle)
    cx0, cy0 = W / 2.0, H / 2.0
    u = c * (xx - cx0) + s * (yy - cy0)
    v = -s * (xx - cx0) + c * (yy - cy0)
    iu = np.floor(u / square_px).astype(int)
    iv = np.floor(v / square_px).astype(int)
    inside = ((np.abs(u) < (cols + 1) / 2 * square_px)
              & (np.abs(v) < (rows + 1) / 2 * square_px))
    img = np.where(inside, ((iu + iv) % 2 == 0) * 1.0, 0.5)
    if noise > 0:
        img = img + np.random.default_rng(seed).normal(size=img.shape) * noise
    # the checker flips at integer multiples of square_px; interior lattice
    # points have |k| < (cols + 1) / 2
    ka = int(np.floor((cols + 1) / 2 - 1e-9))
    kb = int(np.floor((rows + 1) / 2 - 1e-9))
    corners = []
    for a in range(-ka, ka + 1):
        for b in range(-kb, kb + 1):
            uu, vv = a * square_px, b * square_px
            corners.append((c * uu - s * vv + cx0, s * uu + c * vv + cy0))
    return img.astype(np.float32), np.asarray(corners)
