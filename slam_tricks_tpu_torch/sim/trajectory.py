"""Pose-trajectory simulators (port of ``slam_tricks_tpu/sim/trajectory.py``):
the spiral-on-sphere SE(3) path and the pose graph built on it, an
odometry chain with compounding noise plus loop-closure edges.

The graph draws from the same ``numpy.random.default_rng(seed)`` sequence
as the JAX package's, so the two give the same graph up to rounding. It is
built with torch on the CPU in the requested dtype; the finished tensors
go to the card unless the caller names another device.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import se3

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _spiral_np(n, radius, turns, height):
    Rs, ts = [], []
    for i in range(n):
        s = i / max(n - 1, 1)
        ang = 2 * np.pi * turns * s
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), height * s])
        fwd = np.array([-np.sin(ang), np.cos(ang),
                        height / (2 * np.pi * turns * radius)])
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        left = np.cross(up, fwd)
        left /= np.linalg.norm(left)
        up2 = np.cross(fwd, left)
        Rs.append(np.stack([fwd, left, up2], axis=1))
        ts.append(pos)
    return np.stack(Rs), np.stack(ts)


def spiral_poses(n=60, radius=3.0, turns=2.0, height=2.0,
                 dtype=torch.float64, device=None):
    """Deterministic spiral trajectory of T_wb body poses (SE3, (n,))."""
    Rs, ts = _spiral_np(n, radius, turns, height)
    device = resolve(device)
    return se3.SE3(torch.as_tensor(Rs, dtype=dtype, device=device),
                   torch.as_tensor(ts, dtype=dtype, device=device))


class PoseGraphProblem(NamedTuple):
    poses_true: se3.SE3
    poses_init: se3.SE3
    i_idx: torch.Tensor      # (E,) int64
    j_idx: torch.Tensor      # (E,) int64
    Z: se3.SE3               # stacked measurements (E,)
    fixed_mask: torch.Tensor  # (N,) bool, pose 0 fixed


def make_pose_graph(n=40, odo_noise=0.01, loop_every=8, meas_noise=0.005,
                    seed=0, dtype=torch.float64, device=None):
    """Odometry chain with compounding noise plus noisy loop-closure edges
    every `loop_every` poses. The initialization integrates the noisy
    odometry, so drift grows along the chain."""
    rng = np.random.default_rng(seed)
    np_dtype = _NP_DTYPE[dtype]
    Rs, ts = _spiral_np(n, 3.0, 2.0, 2.0)
    truth = se3.SE3(torch.as_tensor(Rs.astype(np_dtype)),
                    torch.as_tensor(ts.astype(np_dtype)))
    loops = [(k, min(k + loop_every, n - 1))
             for k in range(0, n - loop_every, loop_every)]
    i_idx = torch.as_tensor([k for k in range(n - 1)] + [k for k, _ in loops],
                            dtype=torch.int64)
    j_idx = torch.as_tensor([k + 1 for k in range(n - 1)]
                            + [j for _, j in loops], dtype=torch.int64)
    E = i_idx.shape[0]
    # the JAX package draws 6 normals an edge, then 6 a drift, in this order
    meas = torch.as_tensor((rng.normal(size=(E, 6)) * meas_noise)
                           .astype(np_dtype))
    drift = torch.as_tensor((rng.normal(size=(n - 1, 6)) * odo_noise)
                            .astype(np_dtype))
    Zk = se3.mul(se3.inv(se3.SE3(truth.R[i_idx], truth.t[i_idx])),
                 se3.SE3(truth.R[j_idx], truth.t[j_idx]))
    Z = se3.mul(Zk, se3.exp(meas))
    D = se3.exp(drift)
    init = [se3.SE3(truth.R[0], truth.t[0])]
    for k in range(n - 1):
        step = se3.mul(init[-1], se3.SE3(Z.R[k], Z.t[k]))
        init.append(se3.mul(step, se3.SE3(D.R[k], D.t[k])))
    poses_init = se3.SE3(torch.stack([T.R for T in init]),
                         torch.stack([T.t for T in init]))
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[0] = True
    device = resolve(device)
    on = lambda T: se3.SE3(T.R.to(device), T.t.to(device))  # noqa: E731
    return PoseGraphProblem(poses_true=on(truth), poses_init=on(poses_init),
                            i_idx=i_idx.to(device), j_idx=j_idx.to(device),
                            Z=on(Z), fixed_mask=fixed.to(device))
