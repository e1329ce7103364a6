"""The geometric residuals of the port (slam_tricks_tpu_torch/residuals:
the rest of camera.py, simple.py, epipolar.py, icp.py and calib.py)
against the JAX package's, on the same seeded numpy inputs, in f64:

- camera: perspective_divide, distort_pixel on one point and a batch, the
  closed-form Jacobian of the distortion against jax.jacfwd and
  undistort_point_gn in both modes (the exact 2x2 step and the diagonal
  one) against the JAX package's vmapped function: 1e-12 (relative to the
  largest value); undistort_points_gn against the port's
  undistort_points_fast: 1e-9 px;
- simple: the parabola and homography residuals and the weighted
  parabola fit: 1e-12;
- epipolar: algebraic, epiline_distance and sampson, vmapped in JAX,
  with leading batch dimensions in the port (a batch of F too): 1e-12;
- icp: the SE(2) / SE(3) point residuals (1e-12), nearest_neighbors
  (the same indices, also with the source chunked) and icp_iterate at 200
  points (R and t to 1e-10, the same association);
- calib: calib_residual over every corner of a few views (1e-12), pack
  and unpack of the intrinsics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.manifolds import se2 as jse2
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu.residuals import calib as jcalib
from slam_tricks_tpu.residuals import camera as jcam
from slam_tricks_tpu.residuals import epipolar as jepi
from slam_tricks_tpu.residuals import icp as jicp
from slam_tricks_tpu.residuals import simple as jsimple
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.manifolds import se2, se3
from slam_tricks_tpu_torch.residuals import (calib, camera, epipolar, icp,
                                             simple)
from tests.torch_util import rel_err

INTR = (458.654, 457.296, 367.215, 248.375)
DIST = (-0.28340811, 0.07395907, 0.0, 0.00019359, 1.76187114e-05)


def T(a):
    return torch.as_tensor(np.array(a))


def _cam():
    jintr = jcam.Intrinsics(*(jnp.float64(v) for v in INTR))
    jdist = jcam.DistCoeffs(*(jnp.float64(v) for v in DIST))
    return (jintr, jdist, interop.intrinsics_from_jax(jintr, "cpu"),
            interop.dist_from_jax(jdist, "cpu"))


def test_perspective_divide_and_distort_pixel():
    rng = np.random.default_rng(0)
    p = rng.uniform([-1, -1, 2], [1, 1, 5], size=(50, 3))
    got = camera.perspective_divide(T(p))
    ref = jax.vmap(jcam.perspective_divide)(jnp.asarray(p))
    assert rel_err(got, ref) < 1e-15
    jintr, jdist, intr, dist = _cam()
    px = rng.uniform([50, 50], [700, 430], size=(50, 2))
    ref = jax.vmap(lambda q: jcam.distort_pixel(jintr, jdist, q))(
        jnp.asarray(px))
    assert rel_err(camera.distort_pixel(intr, dist, T(px)), ref) < 1e-12
    one = camera.distort_pixel(intr, dist, T(px[3]))        # a single point
    assert one.shape == (2,) and rel_err(one, ref[3]) < 1e-12


def test_distortion_jacobian_matches_jacfwd():
    """The closed form the port takes in place of jax.jacfwd."""
    rng = np.random.default_rng(1)
    p = rng.uniform(-0.6, 0.6, size=(40, 2))
    _, jdist, _, dist = _cam()
    Jref = jax.vmap(jax.jacfwd(lambda q: jcam.distort_normalized(jdist, q)))(
        jnp.asarray(p))
    a, b, c, d = camera._distort_jacobian(dist, T(p[:, 0]), T(p[:, 1]))
    got = torch.stack([torch.stack([a, b], -1), torch.stack([c, d], -1)], -2)
    assert rel_err(got, Jref) < 1e-12


@pytest.mark.parametrize("full_jacobian", [True, False])
@pytest.mark.parametrize("iters", [1, 5])
def test_undistort_point_gn_matches_jax(full_jacobian, iters):
    rng = np.random.default_rng(2)
    jintr, jdist, intr, dist = _cam()
    px = rng.uniform([50, 50], [700, 430], size=(300, 2))
    jpx = jcam.distort_pixels(jintr, jdist, jnp.asarray(px))
    ref = jax.jit(jax.vmap(lambda q: jcam.undistort_point_gn(
        jintr, jdist, q, iters=iters, full_jacobian=full_jacobian)))(jpx)
    got = camera.undistort_points_gn(intr, dist, T(jpx), iters=iters,
                                     full_jacobian=full_jacobian)
    assert got.shape == (300, 2)
    assert rel_err(got, ref) < 1e-12
    if full_jacobian:       # the same Newton steps as the st1 fast path
        fast = camera.undistort_points_fast(intr, dist, T(jpx), iters=iters)
        assert float((got - fast).abs().max()) < 1e-9


def test_simple_residuals_and_parabola_fit():
    rng = np.random.default_rng(3)
    xs = rng.uniform(-3, 3, 60)
    ys = xs ** 2 + 2 * xs + 3 + rng.normal(size=60) * 0.01
    w = rng.uniform(0.2, 1.0, 60)
    prm = np.array([0.9, 2.1, 2.8])
    ref = jsimple.parabola_residual(jnp.asarray(prm), jnp.asarray(xs),
                                    jnp.asarray(ys))
    assert rel_err(simple.parabola_residual(T(prm), T(xs), T(ys)), ref) \
        < 1e-12
    for weights in (None, w):
        ref = jsimple.parabola_fit_lsq(
            jnp.asarray(xs), jnp.asarray(ys),
            None if weights is None else jnp.asarray(weights))
        got = simple.parabola_fit_lsq(T(xs), T(ys),
                                      None if weights is None else T(weights))
        assert rel_err(got, ref) < 1e-12
    h8 = np.array([1.05, 0.1, 2.0, -0.04, 0.98, -1.0, 3e-4, -1e-4])
    src = rng.uniform(-5, 5, size=(40, 2))
    dst = rng.uniform(-5, 5, size=(40, 2))
    ref = jax.vmap(lambda a, b: jsimple.homography_residual(
        jnp.asarray(h8), a, b))(jnp.asarray(src), jnp.asarray(dst))
    assert rel_err(simple.homography_residual(T(h8), T(src), T(dst)), ref) \
        < 1e-12


def test_epipolar_residuals_batched():
    rng = np.random.default_rng(4)
    F = rng.normal(size=(3, 3))
    Fs = rng.normal(size=(5, 3, 3))
    p1 = rng.uniform(-1, 1, size=(30, 2))
    p2 = rng.uniform(-1, 1, size=(30, 2))
    for name in ("algebraic", "epiline_distance", "sampson"):
        jf, tf = getattr(jepi, name), getattr(epipolar, name)
        ref = jax.vmap(lambda a, b: jf(jnp.asarray(F), a, b))(
            jnp.asarray(p1), jnp.asarray(p2))
        assert rel_err(tf(T(F), T(p1), T(p2)), ref) < 1e-12, name
        # a batch of F against every correspondence: (5, 30, ...)
        ref = jax.vmap(lambda Fm: jax.vmap(lambda a, b: jf(Fm, a, b))(
            jnp.asarray(p1), jnp.asarray(p2)))(jnp.asarray(Fs))
        got = tf(T(Fs)[:, None], T(p1), T(p2))
        assert got.shape == ref.shape and rel_err(got, ref) < 1e-12, name


def test_icp_point_residuals():
    rng = np.random.default_rng(5)
    src3, dst3 = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    xi = rng.normal(size=6) * 0.3
    jT = jse3.exp(jnp.asarray(xi))
    ref = jax.vmap(lambda a, b: jicp.point_residual_se3(jT, a, b))(
        jnp.asarray(src3), jnp.asarray(dst3))
    got = icp.point_residual_se3(interop.poses_from_jax(jT, "cpu"), T(src3),
                                 T(dst3))
    assert rel_err(got, ref) < 1e-12
    src2, dst2 = rng.normal(size=(20, 2)), rng.normal(size=(20, 2))
    jT2 = jse2.SE2(jnp.asarray(0.7), jnp.asarray([2.0, -1.0]))
    ref = jax.vmap(lambda a, b: jicp.point_residual_se2(jT2, a, b))(
        jnp.asarray(src2), jnp.asarray(dst2))
    got = icp.point_residual_se2(se2.SE2(T(0.7), T([2.0, -1.0])), T(src2),
                                 T(dst2))
    assert rel_err(got, ref) < 1e-12


def test_nearest_neighbors_matches_jax(monkeypatch):
    rng = np.random.default_rng(6)
    src, dst = rng.normal(size=(300, 3)), rng.normal(size=(257, 3))
    ref = np.asarray(jicp.nearest_neighbors(jnp.asarray(src),
                                            jnp.asarray(dst)))
    assert np.array_equal(icp.nearest_neighbors(T(src), T(dst)).numpy(), ref)
    monkeypatch.setattr(icp, "_NN_ELEMENTS", 257 * 3 * 7)   # chunks of 7
    assert np.array_equal(icp.nearest_neighbors(T(src), T(dst)).numpy(), ref)


@pytest.mark.parametrize("with_scale", [False, True])
def test_icp_iterate_matches_jax(with_scale):
    """Unknown correspondences, 200 shuffled points (the JAX package's
    test_unknown_correspondence_umeyama)."""
    rng = np.random.default_rng(7)
    src = rng.normal(size=(200, 3))
    jT = jse3.exp(jnp.asarray([0.1, 0.2, -0.1, 0.1, -0.08, 0.12]))
    dst = np.asarray(jse3.act(jT, jnp.asarray(src)))
    dst = (1.3 if with_scale else 1.0) * dst[rng.permutation(200)]
    ref = jax.jit(lambda s, d: jicp.icp_iterate(
        s, d, n_outer=20, with_scale=with_scale))(jnp.asarray(src),
                                                  jnp.asarray(dst))
    R, t, s, idx = icp.icp_iterate(T(src), T(dst), n_outer=20,
                                   with_scale=with_scale)
    assert float((R - T(ref[0])).abs().max()) < 1e-10
    assert float((t - T(ref[1])).abs().max()) < 1e-10
    assert abs(float(s) - float(ref[2])) < 1e-10
    assert np.array_equal(idx.numpy(), np.asarray(ref[3]))
    if not with_scale:
        assert float((R - T(jT.R)).abs().max()) < 1e-6


def test_calib_residual_and_packing():
    rng = np.random.default_rng(8)
    jintr, jdist, intr, dist = _cam()
    board = rng.uniform(0, 0.2, size=(12, 2))
    xi = rng.normal(size=(3, 6)) * 0.2 + np.array([0, 0, 0.5, 0, 0, 0])
    jT = jax.vmap(jse3.exp)(jnp.asarray(xi))
    pix = rng.uniform(0, 600, size=(3, 12, 2))
    ref = jax.vmap(lambda Tv, uv: jax.vmap(
        lambda bp, px: jcalib.calib_residual(jintr, jdist, Tv, bp, px))(
            jnp.asarray(board), uv))(jT, jnp.asarray(pix))
    Tt = interop.poses_from_jax(jT, "cpu")
    got = calib.calib_residual(intr, dist, se3.SE3(Tt.R[:, None],
                                                   Tt.t[:, None]),
                               T(board), T(pix))
    assert got.shape == (3, 12, 2) and rel_err(got, ref) < 1e-12
    vec = calib.pack_intrinsics(intr, dist)
    assert rel_err(vec, jcalib.pack_intrinsics(jintr, jdist)) == 0.0
    assert vec.dtype == torch.float64
    i2, d2 = calib.unpack_intrinsics(vec)
    assert [float(v) for v in (*i2, *d2)] == [*INTR, *DIST]
    # numbers (DistCoeffs.zeros()) take the tensors' dtype and device
    assert calib.pack_intrinsics(intr, camera.DistCoeffs.zeros()).dtype \
        == torch.float64
