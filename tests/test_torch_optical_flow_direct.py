"""The port's LK optical flow and direct alignment
(slam_tricks_tpu_torch/frontend/optical_flow.py, frontend/direct.py)
against the JAX package's, on the same seeded numpy inputs:

- build_pyramid (float64): every level to 1e-12 relative;
- grid_seed_points: the same points bit for bit;
- one LK level (_lk_level) and the whole lk_track on
  tests/test_optical_flow_panorama.py's scene (a (3.4, -2.2) px shift,
  3 levels, win 7, 15 iterations), float64 on both sides: the same valid
  mask, tracked points to 1e-8 px; in float32, the JAX test's gate on the
  port (median error below 0.25 px on each axis);
- select_pixels: the valid sites as a set, the invalid by count;
  photometric_residual at a pose: 1e-12;
- direct_pose_estimate on tests/test_distortion_direct.py's scene (a
  textured plane at depth 5, the JAX test's motion, k 256, 40 LM
  iterations, float64): the pose to 1e-8 of the JAX package's, the same
  cost to rtol 1e-6, and the JAX test's gate (max |log error| < 1e-2).

Each JAX reference runs under jax.jit from a module-scoped fixture and is
waited for before the port runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.frontend import direct as jdirect
from slam_tricks_tpu.frontend import optical_flow as jof
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu.ops.image import sample_bilinear as jsample
from slam_tricks_tpu.residuals.camera import Intrinsics as JIntr
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.frontend import direct, optical_flow
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.residuals.camera import Intrinsics
from slam_tricks_tpu_torch.sim.images import shift_image, textured_image
from tests.torch_util import rel_err

LK_SHIFT = (3.4, -2.2)
DA_TWIST = [0.05, -0.03, 0.02, 0.004, -0.006, 0.003]
DA_DEPTH = 5.0


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def lk_scene():
    img1 = textured_image(seed=1)
    img2 = shift_image(img1, *LK_SHIFT)
    pts = optical_flow.grid_seed_points(*img1.shape, grid=5, pts_per_cell=1,
                                        margin=20, seed=2)
    track = jax.jit(functools.partial(jof.lk_track, levels=3, win=7,
                                      iters=15))
    ref = jax.block_until_ready(track(jnp.asarray(img1, jnp.float64),
                                      jnp.asarray(img2, jnp.float64),
                                      jnp.asarray(pts, jnp.float64)))
    return img1, img2, pts, ref


def test_pyramid_and_seeds_match_jax():
    img = textured_image(h=96, w=128, seed=5).astype(np.float64)
    got = optical_flow.build_pyramid(T(img), 4)
    want = jof.build_pyramid(jnp.asarray(img), 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g, w) < 1e-12
    assert np.array_equal(optical_flow.grid_seed_points(100, 140, 4, 3, 10, 7),
                          jof.grid_seed_points(100, 140, 4, 3, 10, 7))


def test_lk_level_matches_jax(lk_scene):
    img1, img2, pts, _ = lk_scene
    guess = np.random.default_rng(3).normal(size=pts.shape)
    args = (img1.astype(np.float64), img2.astype(np.float64),
            pts.astype(np.float64), guess)
    flow, ok = optical_flow._lk_level(*map(T, args), win=5, iters=6)
    jflow, jok = jax.jit(functools.partial(jof._lk_level, win=5, iters=6))(
        *map(jnp.asarray, args))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert float(np.abs(flow.numpy() - np.asarray(jflow)).max()) < 1e-8


def test_lk_track_matches_jax(lk_scene):
    img1, img2, pts, (jpts2, jvalid) = lk_scene
    pts2, valid = optical_flow.lk_track(
        T(img1.astype(np.float64)), T(img2.astype(np.float64)),
        T(pts.astype(np.float64)), levels=3, win=7, iters=15)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert float(np.abs(pts2.numpy() - np.asarray(jpts2)).max()) < 1e-8
    # the JAX test's gate, on the port in float32
    pts2, valid = optical_flow.lk_track(T(img1), T(img2), T(pts), levels=3,
                                        win=7, iters=15)
    flow = (pts2 - T(pts)).numpy()[valid.numpy()]
    assert len(flow) > 10
    err = np.median(np.abs(flow - LK_SHIFT), axis=0)
    assert (err < 0.25).all(), err


def _da_scene(h=120, w=160):
    """tests/test_distortion_direct.py's scene: a smooth random texture and
    its view after the motion DA_TWIST of a plane at depth DA_DEPTH."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(3)
    img1 = gaussian_filter(rng.normal(size=(h, w)), 3.0)
    img1 = (img1 - img1.min()) / np.ptp(img1)
    intr = (150.0, 150.0, w / 2, h / 2)
    T_21 = jse3.exp(jnp.asarray(DA_TWIST))
    T_12 = jse3.inv(T_21)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    u = (xs - intr[2]) / intr[0]
    v = (ys - intr[3]) / intr[1]
    p2 = np.stack([u * DA_DEPTH, v * DA_DEPTH, np.full_like(u, DA_DEPTH)], -1)
    p1 = jse3.act(T_12, jnp.asarray(p2.reshape(-1, 3)))
    x1 = intr[0] * p1[:, 0] / p1[:, 2] + intr[2]
    y1 = intr[1] * p1[:, 1] / p1[:, 2] + intr[3]
    img2 = np.asarray(jsample(jnp.asarray(img1), jnp.stack([x1, y1], 1))
                      ).reshape(h, w)
    return img1, img2, intr, T_21


@pytest.fixture(scope="module")
def da_scene():
    img1, img2, intr, T_21 = _da_scene()
    jintr = JIntr(*map(jnp.float64, intr))
    solve = jax.jit(lambda a, b, d: jdirect.direct_pose_estimate(
        a, b, d, jintr, k=256, max_iters=40))
    ref = jax.block_until_ready(solve(jnp.asarray(img1), jnp.asarray(img2),
                                      jnp.full((256,), DA_DEPTH)))
    return img1, img2, intr, T_21, ref


def test_select_pixels_and_residual_match_jax(da_scene):
    img1, img2, intr, T_21, _ = da_scene
    xy, valid = direct.select_pixels(T(img1), k=300)
    jxy, jvalid = jdirect.select_pixels(jnp.asarray(img1), k=300)
    as_set = lambda a, m: {tuple(p) for p in np.asarray(a)[np.asarray(m)]}
    assert as_set(xy.numpy(), valid.numpy()) == as_set(jxy, jvalid)
    assert int((~valid).sum()) == int((~np.asarray(jvalid)).sum())
    depth = np.random.default_rng(4).uniform(4, 6, 300)
    Tp = jse3.exp(jnp.asarray(DA_TWIST) * 0.5)
    r = direct.photometric_residual(
        interop.poses_from_jax(Tp, "cpu"), T(img1), T(img2),
        T(np.asarray(jxy)), T(depth), Intrinsics(*intr),
        T(np.asarray(jvalid)))
    jr = jdirect.photometric_residual(
        Tp, jnp.asarray(img1), jnp.asarray(img2), jxy, jnp.asarray(depth),
        JIntr(*map(jnp.float64, intr)), jvalid)
    assert float(np.abs(r.numpy() - np.asarray(jr)).max()) < 1e-12


def test_direct_pose_estimate_matches_jax(da_scene):
    img1, img2, intr, T_21, (jT, jres) = da_scene
    T_est, res = direct.direct_pose_estimate(
        T(img1), T(img2), torch.full((256,), DA_DEPTH, dtype=torch.float64),
        Intrinsics(*intr), k=256, max_iters=40)
    assert float((T_est.R - T(jT.R)).abs().max()) < 1e-8
    assert float((T_est.t - T(jT.t)).abs().max()) < 1e-8
    np.testing.assert_allclose(float(res.cost), float(jres.cost), rtol=1e-6)
    err = se3.local(T_est, interop.poses_from_jax(T_21, "cpu")).numpy()
    assert np.abs(err).max() < 1e-2, (err, float(res.cost))
