"""Two-view scene: two cameras and random landmarks (port of
``slam_tricks_tpu/sim/two_view.py``; st22-two-view two_view_simu.cpp).

The landmarks and the noise are drawn by the JAX package's numpy sequence;
the projections are made in the scene's dtype on `device` (the card
unless the caller names another), as the JAX package makes them in its.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.sim.ba_scene import look_at


class TwoViewScene(NamedTuple):
    T1: se3.SE3            # T_cw of camera 1
    T2: se3.SE3
    points: torch.Tensor   # (N, 3) world
    uv1: torch.Tensor      # (N, 2) normalized-plane observations in cam 1
    uv2: torch.Tensor
    T_12: se3.SE3          # T2 inv(T1): cam-1 coordinates -> cam 2


def make_two_view(n_points=100, baseline=1.0, noise=0.0, seed=0,
                  dtype=torch.float64, device=None):
    rng = np.random.default_rng(seed)
    device = resolve(device)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], size=(n_points, 3))
    up = np.array([0.0, 1.0, 0.0])
    R1, t1 = look_at(np.array([0.0, 0.0, 0.0]), np.array([0.0, 0.0, 6.0]),
                     up=up)
    R2, t2 = look_at(np.array([baseline, 0.15, 0.1]),
                     np.array([0.0, 0.0, 6.0]), up=up)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    T1, T2 = se3.SE3(tensor(R1), tensor(t1)), se3.SE3(tensor(R2), tensor(t2))
    p = tensor(pts)
    pc1, pc2 = se3.act(T1, p), se3.act(T2, p)
    uv1 = pc1[:, :2] / pc1[:, 2:]
    uv2 = pc2[:, :2] / pc2[:, 2:]
    if noise > 0:
        uv1 = uv1 + tensor(rng.normal(size=uv1.shape)) * noise
        uv2 = uv2 + tensor(rng.normal(size=uv2.shape)) * noise
    return TwoViewScene(T1=T1, T2=T2, points=p, uv1=uv1, uv2=uv2,
                        T_12=se3.mul(T2, se3.inv(T1)))
