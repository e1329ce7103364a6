"""Deterministic BA scenes (port of ``slam_tricks_tpu/sim/ba_scene.py``):
the st20 cube room of the headline solve, the large-C trajectory scene of
the banded solve and the trajectory scene with loop closures.

Each scene is built in numpy exactly as the JAX package builds it, so the
observation arrays are bit-identical for the same seed; only the final
arrays become torch tensors, on the card unless the caller names another
device.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import se3

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class BAObservations(NamedTuple):
    """Padded observation arrays for the block-sparse solver."""
    cam_idx: torch.Tensor   # (N,) int32
    lm_idx: torch.Tensor    # (N,) int32
    uv: torch.Tensor        # (N, 2) normalized-plane measurements
    weight: torch.Tensor    # (N,), 0 for padding


class BAScene(NamedTuple):
    poses_true: se3.SE3       # (C,) T_cw stacked
    points_true: torch.Tensor  # (L, 3)
    obs: BAObservations
    n_cams: int
    n_points: int


def cube_room_points(n_per_wall=100, half=4.0, seed=0):
    """Features on the 6 walls of a cube room (st20 sim_data.cpp:22-45)."""
    rng = np.random.default_rng(seed)
    pts = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-half, half, size=(n_per_wall, 3))
            p[:, axis] = sign * half
            pts.append(p)
    return np.concatenate(pts, axis=0)


def look_at(eye, target, up=np.array([0.0, 0.0, 1.0])):
    """T_cw of a camera at `eye` looking at `target`, z forward."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    nx = np.linalg.norm(x)
    if nx < 1e-8:
        x = np.array([1.0, 0, 0])
    else:
        x = x / nx
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], axis=1)  # columns = camera axes in world
    R_cw = R_wc.T
    t_cw = -R_cw @ eye
    return R_cw, t_cw


def spiral_trajectory(n_cams=30, radius=2.0, height=1.5, turns=2.0):
    """Spiral inside the room, looking at the origin."""
    Rs, ts = [], []
    for i in range(n_cams):
        s = i / max(n_cams - 1, 1)
        ang = 2.0 * np.pi * turns * s
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang),
                        -height + 2 * height * s])
        R, t = look_at(eye, np.zeros(3))
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)


def make_scene(n_per_wall=100, n_cams=30, half=4.0, fov_tan=1.2,
               min_depth=0.25, pix_noise=0.0, seed=0, dtype=torch.float64,
               device=None):
    """The full scene with visibility-culled, optionally noisy observations,
    padded to a multiple of 8 (padding has weight 0). Tensors go to `device`,
    the card unless the caller names another."""
    np_dtype = _NP_DTYPE[dtype]
    device = resolve(device)
    rng = np.random.default_rng(seed + 1)
    pts = cube_room_points(n_per_wall, half, seed)          # (L, 3)
    Rs, ts = spiral_trajectory(n_cams)                       # (C,3,3), (C,3)

    L = pts.shape[0]
    p_cam = np.einsum("cij,lj->cli", Rs, pts) + ts[:, None, :]   # (C, L, 3)
    z = p_cam[..., 2]
    u = p_cam[..., 0] / np.where(z > min_depth, z, 1.0)
    v = p_cam[..., 1] / np.where(z > min_depth, z, 1.0)
    visible = (z > min_depth) & (np.abs(u) < fov_tan) & (np.abs(v) < fov_tan)
    # a landmark seen fewer than twice cannot be triangulated
    visible &= (visible.sum(axis=0) >= 2)[None, :]

    cam_idx, lm_idx = np.nonzero(visible)
    uv = np.stack([u[cam_idx, lm_idx], v[cam_idx, lm_idx]], axis=1)
    if pix_noise > 0:
        uv = uv + rng.normal(size=uv.shape) * pix_noise

    return _padded_scene(cam_idx, lm_idx, uv, np.ones(cam_idx.shape[0]), Rs,
                         ts, pts, n_cams, L, np_dtype, device)


def _padded_scene(cam_idx, lm_idx, uv, w, Rs, ts, pts, n_cams, n_points,
                  np_dtype, device):
    """A BAScene on `device` from numpy observations, padded with weight-0
    entries to a multiple of 8."""
    pad = (-cam_idx.shape[0]) % 8
    cam_idx = np.concatenate([cam_idx, np.zeros(pad, np.int64)])
    lm_idx = np.concatenate([lm_idx, np.zeros(pad, np.int64)])
    uv = np.concatenate([uv, np.zeros((pad, 2))])
    w = np.concatenate([w, np.zeros(pad)])

    def tensor(a):
        return torch.as_tensor(a, device=device)

    obs = BAObservations(
        cam_idx=tensor(cam_idx.astype(np.int32)),
        lm_idx=tensor(lm_idx.astype(np.int32)),
        uv=tensor(uv.astype(np_dtype)),
        weight=tensor(w.astype(np_dtype)))
    poses = se3.SE3(tensor(Rs.astype(np_dtype)), tensor(ts.astype(np_dtype)))
    return BAScene(poses_true=poses, points_true=tensor(pts.astype(np_dtype)),
                   obs=obs, n_cams=n_cams, n_points=n_points)


def make_trajectory_scene(n_cams=1024, n_points=200_000, track_len=8,
                          radius=50.0, seed=0, pix_noise=0.0,
                          dtype=torch.float32, device=None):
    """Large-scale SLAM-like scene: cameras on a circle looking along its
    tangent, each landmark seen by a window of `track_len` consecutive
    cameras, so the reduced camera system is block-banded. Observations are
    sorted by landmark; one that falls behind its camera (z <= 0.5), and
    every observation of a landmark left with fewer than two, has weight 0.
    Tensors go to `device`, the card unless the caller names another."""
    np_dtype = _NP_DTYPE[dtype]
    device = resolve(device)
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    eyes = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.zeros(n_cams)], axis=1)
    fwd = np.stack([-np.sin(ang), np.cos(ang), np.zeros(n_cams)], axis=1)
    Rs, ts = [], []
    for i in range(n_cams):
        R, t = look_at(eyes[i], eyes[i] + fwd[i])
        Rs.append(R)
        ts.append(t)
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    # each landmark anchored ahead of the middle camera of its window
    c0 = rng.integers(0, n_cams - track_len + 1, size=n_points)
    mid = c0 + track_len // 2
    local = np.stack([
        rng.uniform(-1.5, 1.5, n_points),
        rng.uniform(-1.5, 1.5, n_points),
        rng.uniform(6.0, 14.0, n_points),
    ], axis=1)
    pts = np.einsum("nji,nj->ni", Rs[mid], local - ts[mid])   # R^T (p - t)

    cam_idx = (c0[:, None] + np.arange(track_len)[None, :]).reshape(-1)
    lm_idx = np.repeat(np.arange(n_points), track_len)
    p_cam = (np.einsum("nij,nj->ni", Rs[cam_idx], pts[lm_idx])
             + ts[cam_idx])
    z = p_cam[:, 2]
    valid = z > 0.5
    uv = p_cam[:, :2] / np.where(valid, z, 1.0)[:, None]
    if pix_noise > 0:
        uv = uv + rng.normal(size=uv.shape) * pix_noise
    w = valid.astype(np.float64)
    n_valid = np.bincount(lm_idx, weights=w, minlength=n_points)
    w = w * (n_valid[lm_idx] >= 2)
    return _padded_scene(cam_idx, lm_idx, uv, w, Rs, ts, pts, n_cams,
                         n_points, np_dtype, device)


def make_loop_scene(n_cams=1024, n_points=200_000, track_len=8,
                    loop_frac=None, radius=50.0, seed=0, pix_noise=0.0,
                    dtype=torch.float32, device=None):
    """The trajectory scene with loop closures: cameras on a circle as in
    make_trajectory_scene, and every landmark anchored in the start window
    [0, track_len) is seen again by the last `track_len` cameras, so its
    track is two runs of consecutive cameras (the loop closing as the
    circle completes). loop_frac: the fraction of landmarks forced into
    the start window (None keeps the uniform anchors, ~track_len / n_cams
    of them loop closures). Raises ValueError for n_cams < 2 track_len,
    where the two runs would overlap. Tensors go to `device`, the card
    unless the caller names another."""
    if n_cams < 2 * track_len:
        raise ValueError(
            f"make_loop_scene needs n_cams >= 2*track_len "
            f"(got n_cams={n_cams}, track_len={track_len}): the revisit "
            "run would overlap the primary run")
    np_dtype = _NP_DTYPE[dtype]
    device = resolve(device)
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    eyes = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.zeros(n_cams)], axis=1)
    fwd = np.stack([-np.sin(ang), np.cos(ang), np.zeros(n_cams)], axis=1)
    Rs, ts = [], []
    for i in range(n_cams):
        R, t = look_at(eyes[i], eyes[i] + fwd[i])
        Rs.append(R)
        ts.append(t)
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    c0 = rng.integers(0, n_cams - track_len + 1, size=n_points)
    if loop_frac is not None:
        n_loop = int(loop_frac * n_points)
        c0[:n_loop] = rng.integers(0, track_len, size=n_loop)
    mid = c0 + track_len // 2
    local = np.stack([
        rng.uniform(-1.5, 1.5, n_points),
        rng.uniform(-1.5, 1.5, n_points),
        rng.uniform(6.0, 14.0, n_points),
    ], axis=1)
    pts = np.einsum("nji,nj->ni", Rs[mid], local - ts[mid])

    # the primary runs, then the revisit run of the start-window landmarks
    cam_idx = (c0[:, None] + np.arange(track_len)[None, :]).reshape(-1)
    lm_idx = np.repeat(np.arange(n_points), track_len)
    loop_lms = np.flatnonzero(c0 < track_len)
    rev_cams = np.arange(n_cams - track_len, n_cams)
    cam_idx = np.concatenate([cam_idx, np.tile(rev_cams, loop_lms.size)])
    lm_idx = np.concatenate([lm_idx, np.repeat(loop_lms, track_len)])

    p_cam = (np.einsum("nij,nj->ni", Rs[cam_idx], pts[lm_idx])
             + ts[cam_idx])
    z = p_cam[:, 2]
    valid = z > 0.5
    uv = p_cam[:, :2] / np.where(valid, z, 1.0)[:, None]
    if pix_noise > 0:
        uv = uv + rng.normal(size=uv.shape) * pix_noise
    w = valid.astype(np.float64)
    n_valid = np.bincount(lm_idx, weights=w, minlength=n_points)
    w = w * (n_valid[lm_idx] >= 2)
    return _padded_scene(cam_idx, lm_idx, uv, w, Rs, ts, pts, n_cams,
                         n_points, np_dtype, device)


def perturb_scene(scene, pose_rot_noise=0.05, pose_trans_noise=0.1,
                  point_noise=0.1, seed=10, fix_first=True, fix_last=True):
    """Noisy initialization: perturb every pose (se3.retract, tangent
    [rho, omega]) and point; the fixed cameras (first and last, which pin
    the 7-DoF similarity gauge of monocular BA) keep their true value.

    Returns (poses0, points0, pose_fixed_mask)."""
    rng = np.random.default_rng(seed)
    C = scene.n_cams
    points_true = scene.points_true
    np_dtype = _NP_DTYPE[points_true.dtype]
    xi = np.concatenate([
        rng.normal(size=(C, 3)) * pose_trans_noise,
        rng.normal(size=(C, 3)) * pose_rot_noise,
    ], axis=1)
    fixed = np.zeros(C, bool)
    if fix_first:
        fixed[0] = True
    if fix_last:
        fixed[C - 1] = True
    xi[fixed] = 0.0
    device = points_true.device
    poses0 = se3.retract(scene.poses_true,
                         torch.as_tensor(xi.astype(np_dtype), device=device))
    noise = rng.normal(size=(scene.n_points, 3)).astype(np_dtype)
    points0 = points_true + torch.as_tensor(noise, device=device) * point_noise
    return poses0, points0, torch.as_tensor(fixed, device=device)
