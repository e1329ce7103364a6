"""Sensor-distortion simulators: a rolling-shutter camera and a spinning
LiDAR on a moving base (port of ``slam_tricks_tpu/sim/distortion.py``;
st19 rolling_shut.h:44-66, lidar.h:63-106, LineIntersection :152-182).

Both are closed form over a batch: the rolling shutter solves each point's
scanline-meets-moving-point equation in one elementwise pass, and the LiDAR
intersects every (beam x wall) pair at once, where the JAX package maps
the beams with ``vmap``, and keeps each beam's nearest positive range.
"""

import math
from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import se2


def rolling_shutter_points(pts0, vel, row_time, t0=0.0):
    """Observed positions (N, 2) of points moving linearly from pts0 (N, 2)
    (pixels, y the row) at vel (N, 2) px/s under a rolling shutter exposing
    row y at t0 + y row_time (rolling_shut.h:44):
        y_obs = (y0 + vy t0) / (1 - vy row_time)
        x_obs = x0 + vx (t0 + y_obs row_time)"""
    x0, y0 = pts0[:, 0], pts0[:, 1]
    vx, vy = vel[:, 0], vel[:, 1]
    y_obs = (y0 + vy * t0) / (1.0 - vy * row_time)
    x_obs = x0 + vx * (t0 + y_obs * row_time)
    return torch.stack([x_obs, y_obs], dim=1)


def ray_segment_intersection(origin, direction, seg_a, seg_b):
    """Ranges t along rays origin + t direction (..., 2) (direction unit)
    to the segments seg_a -> seg_b (..., 2), all broadcast together; inf
    where a ray misses (parallel, behind, or off the segment)."""
    d = direction
    e = seg_b - seg_a
    denom = d[..., 0] * e[..., 1] - d[..., 1] * e[..., 0]
    safe = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom),
                       denom)
    ao = seg_a - origin
    t = (ao[..., 0] * e[..., 1] - ao[..., 1] * e[..., 0]) / safe
    s = (ao[..., 0] * d[..., 1] - ao[..., 1] * d[..., 0]) / safe
    valid = (torch.abs(denom) > 1e-12) & (t > 1e-9) & (s >= 0.0) & (s <= 1.0)
    return torch.where(valid, t, torch.full_like(t, float("inf")))


class LidarSweep(NamedTuple):
    angles: torch.Tensor        # (B,) beam angles in the world frame
    ranges: torch.Tensor        # (B,) measured ranges (inf: no return)
    points_world: torch.Tensor  # (B, 2) hit points in the world frame
    origins: torch.Tensor       # (B, 2) the sensor's origin at each fire


def lidar_sweep(segments, base_start, base_vel, n_beams=360, sweep_time=0.1,
                beam_angle0=0.0):
    """A spinning LiDAR on a moving base (lidar.h:63-106): segments (S, 2,
    2) world walls, base_start an ``se2.SE2`` at the sweep's start,
    base_vel (3,) the twist [vx, vy, omega] held over the sweep; beams fire
    uniformly over sweep_time while the scanner turns once, each from the
    base pose at its fire time. Returns a ``LidarSweep``."""
    dtype, device = segments.dtype, segments.device
    ts = (sweep_time * (torch.arange(n_beams, dtype=torch.float64,
                                     device=device) / n_beams)).to(dtype)
    rel_angles = beam_angle0 + 2.0 * math.pi * ts / sweep_time
    pose = se2.mul(base_start, se2.exp(base_vel * ts[:, None]))
    ang = pose.theta + rel_angles
    d = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)      # (B, 2)
    o = pose.t
    rngs = ray_segment_intersection(o[:, None], d[:, None],
                                    segments[:, 0], segments[:, 1])
    r = torch.min(rngs, dim=1).values
    hit = torch.where(torch.isfinite(r), r, torch.zeros_like(r))
    return LidarSweep(angles=ang, ranges=r, points_world=o + hit[:, None] * d,
                      origins=o)


def box_segments(half=4.0, dtype=torch.float32, device=None):
    """A square room's four walls (4, 2, 2), on `device` (the card unless
    the caller names another)."""
    return torch.tensor([
        [[-half, -half], [half, -half]],
        [[half, -half], [half, half]],
        [[half, half], [-half, half]],
        [[-half, half], [-half, -half]],
    ], dtype=dtype, device=resolve(device))
