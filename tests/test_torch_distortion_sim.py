"""The port's sensor-distortion simulators
(slam_tricks_tpu_torch/sim/distortion.py) against the JAX package's, on
the same seeded numpy inputs, in float64:

- rolling_shutter_points on random points and velocities: 1e-12; the JAX
  tests' shear and stretch;
- ray_segment_intersection for one ray and for a batch of rays against
  random segments (misses included): the same inf pattern, finite ranges
  to 1e-12;
- lidar_sweep on box_segments for a still base, a moving and turning base,
  and a start off the origin: every field to 1e-9; the JAX tests' static
  range profile and moving-base distortion on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.manifolds import se2 as jse2
from slam_tricks_tpu.sim import distortion as jdist
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.manifolds import se2
from slam_tricks_tpu_torch.sim import distortion as dist
from tests.torch_util import rel_err

RNG = np.random.default_rng(31)
F64 = torch.float64


def T(a):
    return torch.as_tensor(np.array(a))


def test_rolling_shutter_matches_jax():
    pts = RNG.uniform(0, 400, (64, 2))
    vel = RNG.normal(size=(64, 2)) * 300
    for row_time, t0 in ((1e-4, 0.0), (5e-5, 0.003)):
        got = dist.rolling_shutter_points(T(pts), T(vel), row_time, t0)
        want = jdist.rolling_shutter_points(jnp.asarray(pts),
                                            jnp.asarray(vel), row_time, t0)
        assert rel_err(got, want) < 1e-12
    y = torch.tensor([0.0, 100.0, 200.0], dtype=F64)
    obs = dist.rolling_shutter_points(
        torch.stack([torch.full((3,), 50.0, dtype=F64), y], dim=1),
        torch.tensor([[1000.0, 0.0]] * 3, dtype=F64), 1e-4)
    np.testing.assert_allclose(obs[:, 0].numpy() - 50.0, [0, 10, 20],
                               atol=1e-9)
    obs = dist.rolling_shutter_points(torch.tensor([[0.0, 100.0]], dtype=F64),
                                      torch.tensor([[0.0, 500.0]], dtype=F64),
                                      1e-4)
    assert abs(float(obs[0, 1]) - 100.0 / 0.95) < 1e-9


def test_ray_segment_intersection_matches_jax():
    a = RNG.uniform(-5, 5, (30, 2))
    b = RNG.uniform(-5, 5, (30, 2))
    segs = jdist.box_segments(4.0, jnp.float64)
    t = dist.ray_segment_intersection(T([0.0, 0.0]), T([1.0, 0.0]),
                                      T(segs[:, 0]), T(segs[:, 1]))
    assert abs(float(t.min()) - 4.0) < 1e-12
    for k in range(8):
        o = RNG.uniform(-1, 1, 2)
        ang = RNG.uniform(0, 2 * np.pi)
        d = np.array([np.cos(ang), np.sin(ang)])
        got = dist.ray_segment_intersection(T(o), T(d), T(a), T(b)).numpy()
        want = np.asarray(jdist.ray_segment_intersection(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        if fin.any():
            assert float(np.abs(got[fin] - want[fin]).max()) < 1e-12
    # a batch of rays (B, 1, 2) against all segments at once
    o = RNG.uniform(-1, 1, (16, 2))
    ang = RNG.uniform(0, 2 * np.pi, 16)
    d = np.stack([np.cos(ang), np.sin(ang)], 1)
    got = dist.ray_segment_intersection(T(o)[:, None], T(d)[:, None], T(a),
                                        T(b)).numpy()
    for i in range(16):
        want = np.asarray(jdist.ray_segment_intersection(
            jnp.asarray(o[i]), jnp.asarray(d[i]), jnp.asarray(a),
            jnp.asarray(b)))
        assert np.array_equal(np.isfinite(got[i]), np.isfinite(want))
        np.testing.assert_allclose(got[i][np.isfinite(want)],
                                   want[np.isfinite(want)], rtol=1e-12)


@pytest.mark.parametrize("start, vel, n_beams", [
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 360),
    ((0.0, 0.0, 0.0), (8.0, 0.0, 0.0), 180),
    ((0.3, 0.5, -0.2), (2.0, -1.0, 3.0), 361),
])
def test_lidar_sweep_matches_jax(start, vel, n_beams):
    th, x, y = start
    want = jdist.lidar_sweep(jdist.box_segments(4.0, jnp.float64),
                             jse2.SE2(jnp.asarray(th), jnp.asarray([x, y])),
                             jnp.asarray(vel), n_beams=n_beams)
    segs = dist.box_segments(4.0, F64, device="cpu")
    assert np.array_equal(segs.numpy(),
                          np.asarray(jdist.box_segments(4.0, jnp.float64)))
    got = dist.lidar_sweep(segs, se2.SE2(torch.tensor(th, dtype=F64),
                                         torch.tensor([x, y], dtype=F64)),
                           torch.tensor(vel, dtype=F64), n_beams=n_beams)
    assert isinstance(got, dist.LidarSweep)
    want = interop.lidar_sweep_from_jax(want, "cpu")
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) < 1e-9, name


def test_lidar_sweep_profiles():
    """tests/test_distortion_direct.py's gates, on the port."""
    segs = dist.box_segments(4.0, F64, device="cpu")
    base = se2.SE2(torch.tensor(0.0, dtype=F64), torch.zeros(2, dtype=F64))
    sweep = dist.lidar_sweep(segs, base, torch.zeros(3, dtype=F64))
    r = sweep.ranges.numpy()
    assert np.isfinite(r).all()
    assert abs(r[0] - 4.0) < 1e-6 and abs(r[45] - 4.0 * np.sqrt(2)) < 2e-1
    p = np.max(np.abs(sweep.points_world.numpy()), axis=1)
    assert np.all(p < 4.0 + 1e-6) and np.all(p > 4.0 - 1e-6)
    still = dist.lidar_sweep(segs, base, torch.zeros(3, dtype=F64),
                             n_beams=180)
    moving = dist.lidar_sweep(segs, base, torch.tensor([8.0, 0.0, 0.0],
                                                       dtype=F64),
                              n_beams=180)
    assert abs(float(still.ranges[-1] - moving.ranges[-1])) > 1e-2
