"""A long sequential capture: cameras on a circle looking along its
tangent, each landmark seen by a run of consecutive cameras, so that the
reduced camera system is block-banded. The geometry is a numpy copy of
``slam_tricks_tpu_torch/sim/ba_scene.make_trajectory_scene``; the track
length may be fractional (its mean), as a published problem's
observations over points is."""

import math

import numpy as np

from benchmark.harness.scenes import Scene, look_at


def make(n_cams, n_points, track_len, radius=50.0, seed=0):
    """Each landmark is anchored 6-14 m ahead of the middle camera of a run
    of floor(track_len) or ceil(track_len) consecutive cameras (the longer
    with probability track_len - floor(track_len)) and seen by all of them.
    An observation behind its camera (z <= 0.5), and every observation of
    a landmark left with fewer than two, has weight 0."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    eyes = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.zeros(n_cams)], axis=1)
    fwd = np.stack([-np.sin(ang), np.cos(ang), np.zeros(n_cams)], axis=1)
    Rs, ts = zip(*(look_at(eyes[i], eyes[i] + fwd[i]) for i in range(n_cams)))
    Rs, ts = np.stack(Rs), np.stack(ts)
    short = math.floor(track_len)
    length = short + (rng.random(n_points) < track_len - short)
    c0 = (rng.random(n_points) * (n_cams - length + 1)).astype(np.int64)
    mid = c0 + length // 2
    local = np.stack([rng.uniform(-1.5, 1.5, n_points),
                      rng.uniform(-1.5, 1.5, n_points),
                      rng.uniform(6.0, 14.0, n_points)], axis=1)
    pts = np.einsum("nji,nj->ni", Rs[mid], local - ts[mid])
    lm = np.repeat(np.arange(n_points), length)
    start = np.cumsum(length) - length
    cam = c0[lm] + (np.arange(lm.shape[0]) - start[lm])
    p_cam = np.einsum("nij,nj->ni", Rs[cam], pts[lm]) + ts[cam]
    z = p_cam[:, 2]
    valid = z > 0.5
    uv = p_cam[:, :2] / np.where(valid, z, 1.0)[:, None]
    w = valid.astype(np.float64)
    n_valid = np.bincount(lm, weights=w, minlength=n_points)
    w = w * (n_valid[lm] >= 2)
    return Scene(Rs, ts, pts, cam.astype(np.int64), lm.astype(np.int64), uv,
                 w)
