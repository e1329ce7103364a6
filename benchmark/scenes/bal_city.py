"""An unordered photo collection of a city square, at a BAL problem's
counts: cameras standing inside a square about 100 m across, most of them
turned to a monument at its middle and the rest to its facades, each with
its own focal length and radial distortion (BAL's 9-parameter camera,
``benchmark/reference/lm_bal.py``), and tracks whose lengths follow a
heavy-tailed discrete power law, as a photo collection's do.

Poses are world to camera, the camera looking along +z (BAL's files look
along -z: a rotation of pi about z, which changes no number here).
Measurements are in pixels about the principal point, noiseless. The
draws come from the seed, one stream each for the poses, the intrinsics,
the points and the tracks: ``intrinsics`` draws the same intrinsics as
``make`` without building the scene.
"""

import numpy as np

from benchmark.harness.scenes import Scene, look_at

_POSES, _INTR, _POINTS, _TRACKS = range(4)


def _rng(seed, stream):
    return np.random.default_rng([int(seed), stream])


def intrinsics(n_cams, seed=0, f_range=(500.0, 1000.0), k1=0.1, k2=0.02,
               **_):
    """(C, 3) [f, k1, k2]: f ~ U(f_range), k1 ~ U(-k1, k1),
    k2 ~ U(-k2, k2)."""
    rng = _rng(seed, _INTR)
    return np.stack([rng.uniform(*f_range, n_cams),
                     rng.uniform(-k1, k1, n_cams),
                     rng.uniform(-k2, k2, n_cams)], axis=1)


def _power_law(lo, hi, mean):
    """p(k) ~ k^-alpha on [lo, hi], alpha set by bisection so that the
    mean is `mean`: (k, p, alpha)."""
    k = np.arange(lo, hi + 1, dtype=np.float64)
    a, b = 0.0, 10.0
    for _ in range(100):
        alpha = 0.5 * (a + b)
        p = k ** -alpha
        if (k * p).sum() / p.sum() > mean:
            a = alpha
        else:
            b = alpha
    return k.astype(np.int64), p / p.sum(), alpha


def _visible(R, t, intr, X, width, height, depth):
    """(n, C) bool: points X (n, 3) in front of each camera at a depth in
    `depth`, inside the image with and without the distortion, where it is
    one to one (its radial derivative above 0.5). Elementwise, a camera at
    a time (no matrix product: the same bits on any BLAS)."""
    hw, hh = width / 2.0, height / 2.0
    x0, x1, x2 = (np.ascontiguousarray(X[:, i]) for i in range(3))
    out = np.zeros((X.shape[0], R.shape[0]), bool)
    for c in range(R.shape[0]):
        r, f, k1, k2 = R[c], intr[c, 0], intr[c, 1], intr[c, 2]
        z = r[2, 0] * x0 + r[2, 1] * x1 + r[2, 2] * x2 + t[c, 2]
        ok = (z >= depth[0]) & (z <= depth[1])
        iz = 1.0 / np.where(ok, z, 1.0)
        u = (r[0, 0] * x0 + r[0, 1] * x1 + r[0, 2] * x2 + t[c, 0]) * iz
        v = (r[1, 0] * x0 + r[1, 1] * x1 + r[1, 2] * x2 + t[c, 1]) * iz
        ok &= (np.abs(f * u) <= hw) & (np.abs(f * v) <= hh)
        r2 = u * u + v * v
        a = 1.0 + r2 * (k1 + k2 * r2)
        ok &= (a + 2.0 * r2 * (k1 + 2.0 * k2 * r2) > 0.5)
        ok &= (np.abs(f * a * u) <= hw) & (np.abs(f * a * v) <= hh)
        out[:, c] = ok
    return out


def _points(rng, n, half, monument, wall_height):
    """n points: a share `monument[0]` in the monument's box (half-width
    monument[1], height monument[2]) at the middle, the rest on the four
    facades around the square (half-size `half`)."""
    on_m = rng.random(n) < monument[0]
    m = np.stack([rng.uniform(-monument[1], monument[1], n),
                  rng.uniform(-monument[1], monument[1], n),
                  rng.uniform(0.0, monument[2], n)], axis=1)
    wall = rng.integers(0, 4, n)
    along = rng.uniform(-half, half, n)
    side = np.where(wall % 2 == 0, half, -half)
    f = np.stack([np.where(wall < 2, side, along),
                  np.where(wall < 2, along, side),
                  rng.uniform(0.0, wall_height, n)], axis=1)
    return np.where(on_m[:, None], m, f)


_MADE = {}     # the last scene made, by its arguments


def make(**spec):
    """The scene of ``make_scene``'s arguments (``_make``), kept: the
    benchmark's readers of the work a layer does ask for the scene of the
    run again."""
    key = repr(sorted(spec.items()))
    if key not in _MADE:
        _MADE.clear()
        _MADE[key] = _make(**spec)
    return _MADE[key]


def _make(n_cams, n_points, n_observations, seed=0, half=50.0,
         monument=(0.15, 5.0, 20.0), to_monument=0.75, wall_height=25.0,
         width=1200, height=900, depth=(2.0, 80.0), f_range=(500.0, 1000.0),
         k1=0.1, k2=0.02, max_track=None):
    """The scene, with exactly n_observations observations.

    Cameras stand at (x, y) ~ U(-0.84 half, 0.84 half)², at least 8 m from
    the middle, 1.4-2.0 m up; a share `to_monument` looks at a point of the
    monument, the others at a point of a facade. Each track's length is
    drawn from a discrete power law on [2, max_track] (default: every
    camera) whose exponent makes the mean n_observations / n_points; the
    lengths, sorted, go to the points sorted by how many cameras see them,
    each capped at that number, and the observations the caps remove go,
    one at a time, to points with cameras to spare (drawn from the seed).
    Each point's cameras are drawn among those that see it. A point that
    fewer than two cameras see is drawn again."""
    rng = _rng(seed, _POSES)
    eyes = np.zeros((n_cams, 3))
    filled = 0
    while filled < n_cams:
        xy = rng.uniform(-0.84 * half, 0.84 * half, (n_cams, 2))
        xy = xy[np.hypot(xy[:, 0], xy[:, 1]) >= 8.0][:n_cams - filled]
        eyes[filled:filled + xy.shape[0], :2] = xy
        filled += xy.shape[0]
    eyes[:, 2] = rng.uniform(1.4, 2.0, n_cams)
    to_m = rng.random(n_cams) < to_monument
    m_target = np.stack([rng.uniform(-0.8 * monument[1], 0.8 * monument[1],
                                     n_cams),
                         rng.uniform(-0.8 * monument[1], 0.8 * monument[1],
                                     n_cams),
                         rng.uniform(2.0, 0.75 * monument[2], n_cams)], 1)
    f_target = _points(rng, n_cams, half, (0.0, 0.0, 0.0), wall_height)
    f_target[:, 2] = rng.uniform(2.0, 0.6 * wall_height, n_cams)
    targets = np.where(to_m[:, None], m_target, f_target)
    Rs, ts = zip(*(look_at(eyes[i], targets[i]) for i in range(n_cams)))
    R, t = np.stack(Rs), np.stack(ts)
    intr = intrinsics(n_cams, seed, f_range, k1, k2)

    prng = _rng(seed, _POINTS)
    X = _points(prng, n_points, half, monument, wall_height)
    vis = _visible(R, t, intr, X, width, height, depth)
    for _ in range(100):
        redo = np.flatnonzero(vis.sum(1) < 2)
        if redo.size == 0:
            break
        X[redo] = _points(prng, redo.size, half, monument, wall_height)
        vis[redo] = _visible(R, t, intr, X[redo], width, height, depth)
    else:
        raise RuntimeError("bal_city: points that two cameras see are too "
                           "rare in this scene")
    seen = vis.sum(1)

    trng = _rng(seed, _TRACKS)
    ks, p, _ = _power_law(2, max_track or n_cams, n_observations / n_points)
    k = np.sort(trng.choice(ks, size=n_points, p=p))[::-1]
    by_seen = np.lexsort((np.arange(n_points), -seen))
    length = np.empty(n_points, np.int64)
    length[by_seen] = k
    length = np.minimum(length, seen)
    while length.sum() != n_observations:
        short = n_observations - int(length.sum())
        room = np.flatnonzero(length < seen if short > 0 else length > 2)
        if room.size == 0:
            raise RuntimeError("bal_city: the scene cannot hold "
                               f"{n_observations} observations")
        pick = trng.choice(room, size=min(abs(short), room.size),
                           replace=False)
        length[pick] += np.sign(short)

    # each point's cameras: selection sampling over the cameras in order,
    # camera c taken with probability (still to take) / (still seen)
    need, left = length.copy(), seen.copy()
    take = np.zeros((n_points, n_cams), bool)
    for c in range(n_cams):
        v = vis[:, c]
        pick = v & (trng.random(n_points) * left < need)
        take[:, c] = pick
        need -= pick
        left -= v
    lm, cam = np.nonzero(take)
    uv = np.empty((lm.shape[0], 2))
    for i in range(0, lm.shape[0], 1 << 18):
        c, l = cam[i:i + (1 << 18)], lm[i:i + (1 << 18)]
        p_ = [R[c, j, 0] * X[l, 0] + R[c, j, 1] * X[l, 1]
              + R[c, j, 2] * X[l, 2] + t[c, j] for j in range(3)]
        x, y = p_[0] / p_[2], p_[1] / p_[2]
        r2 = x * x + y * y
        s = intr[c, 0] * (1.0 + r2 * (intr[c, 1] + intr[c, 2] * r2))
        uv[i:i + (1 << 18)] = np.stack([s * x, s * y], axis=1)
    return Scene(R, t, X, cam, lm, uv, np.ones(lm.shape[0]))
