"""st20's cube room (sim_data.cpp:22-96), a numpy copy of
``slam_tricks_tpu_torch/sim/ba_scene.make_scene``: features on the six
walls of a cube, cameras on a spiral looking at the origin."""

import numpy as np

from benchmark.harness.scenes import Scene, look_at


def make(n_per_wall, n_cams, half=4.0, fov_tan=1.2, min_depth=0.25,
         radius=2.0, height=1.5, turns=2.0, seed=0):
    """n_per_wall uniform features on each of the six walls of a cube of
    half-size `half`, cameras on a spiral of `turns` turns looking at the
    origin; an observation is kept where the point lies ahead (z >
    min_depth) inside the field of view, and a point seen by fewer than two
    cameras is dropped."""
    rng = np.random.default_rng(seed)
    walls = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            p = rng.uniform(-half, half, size=(n_per_wall, 3))
            p[:, axis] = sign * half
            walls.append(p)
    pts = np.concatenate(walls, axis=0)
    Rs, ts = [], []
    for i in range(n_cams):
        s = i / max(n_cams - 1, 1)
        ang = 2.0 * np.pi * turns * s
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang),
                        -height + 2 * height * s])
        R, t = look_at(eye, np.zeros(3))
        Rs.append(R)
        ts.append(t)
    Rs, ts = np.stack(Rs), np.stack(ts)
    p_cam = np.einsum("cij,lj->cli", Rs, pts) + ts[:, None, :]
    z = p_cam[..., 2]
    zs = np.where(z > min_depth, z, 1.0)
    u, v = p_cam[..., 0] / zs, p_cam[..., 1] / zs
    visible = (z > min_depth) & (np.abs(u) < fov_tan) & (np.abs(v) < fov_tan)
    visible &= (visible.sum(axis=0) >= 2)[None, :]
    cam, lm = np.nonzero(visible)
    uv = np.stack([u[cam, lm], v[cam, lm]], axis=1)
    return Scene(Rs, ts, pts, cam.astype(np.int64), lm.astype(np.int64), uv,
                 np.ones(cam.shape[0]))
