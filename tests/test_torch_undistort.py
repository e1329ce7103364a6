"""Newton undistortion (slam_tricks_tpu_torch/residuals/camera.py and
ops/undistort.py) against the JAX package's camera.undistort_points_fast
and the Pallas kernel ``pallas_undistort.undistort_points_pallas`` in
interpret mode: f64 to 1e-9 px, with the round trip to 1e-6 px (the bounds
of tests/test_fast_undistort.py); f32 on a ragged count of pixels to
2.5e-4 px (a few ulp at 700 px); 1, 5 and 8 Newton steps, the round trip
only where the steps have converged. The CUDA kernel is held against the
plain version in test_torch_cuda.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.ops.pallas_undistort import undistort_points_pallas
from slam_tricks_tpu.residuals import camera as jcam
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.ops import _build
from slam_tricks_tpu_torch.residuals import camera
import tests.torch_util  # noqa: F401  (caps torch's threads)

INTR = (458.654, 457.296, 367.215, 248.375)
DIST = (-0.28340811, 0.07395907, 0.0, 0.00019359, 1.76187114e-05)


@pytest.mark.parametrize("n, dtype, tol, trip, iters", [
    (500, np.float64, 1e-9, 1e-6, 5),
    (3000, np.float32, 2.5e-4, 1e-3, 5),
    (301, np.float64, 1e-9, None, 1),
    (301, np.float32, 2.5e-4, None, 1),
    (1001, np.float32, 2.5e-4, 1e-3, 8),
])
def test_undistort_matches_jax(n, dtype, tol, trip, iters):
    rng = np.random.default_rng(5)
    px = rng.uniform([50, 50], [700, 430], size=(n, 2)).astype(dtype)
    jintr = jcam.Intrinsics(*(jnp.asarray(v, dtype) for v in INTR))
    jdist = jcam.DistCoeffs(*(jnp.asarray(v, dtype) for v in DIST))
    jdist_px = jcam.distort_pixels(jintr, jdist, jnp.asarray(px))
    ref = np.asarray(jcam.undistort_points_fast(jintr, jdist, jdist_px,
                                                iters=iters))
    pal = np.asarray(undistort_points_pallas(jintr, jdist, jdist_px,
                                             iters=iters, interpret=True))

    intr = interop.intrinsics_from_jax(jintr, "cpu")
    dist = interop.dist_from_jax(jdist, "cpu")
    dist_px = camera.distort_pixels(intr, dist, torch.as_tensor(px))
    np.testing.assert_allclose(dist_px.numpy(), np.asarray(jdist_px),
                               rtol=0, atol=tol)
    out = camera.undistort_points_fast(intr, dist, interop.tensor(jdist_px,
                                                                  "cpu"),
                                       iters=iters)
    assert out.dtype == dist_px.dtype and out.shape == (n, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    np.testing.assert_allclose(out.numpy(), pal, rtol=0, atol=tol)
    if trip is not None:    # round trip through the port alone
        back = camera.undistort_points_fast(intr, dist, dist_px, iters=iters)
        assert np.abs(back.numpy().astype(np.float64) - px).max() < trip


def test_undistort_signature_counts_in_64_bits():
    """The pixel count crosses ctypes as a 64-bit integer: a c_int would
    wrap 2**31 + 5 to a negative count without an error."""
    for name in ("undistort_f32", "undistort_f64"):
        count = _build.SIGNATURES[name][2]
        assert count is ctypes.c_int64
        assert count(2 ** 31 + 5).value == 2 ** 31 + 5
    assert ctypes.c_int(2 ** 31 + 5).value < 0


def test_undistort_strided_view_matches_jax():
    """pts[:, :2] of an (N, 3) array, not contiguous, gives the JAX
    package's result."""
    rng = np.random.default_rng(11)
    pts = rng.uniform([50, 50, 0], [700, 430, 1], size=(257, 3))
    jintr = jcam.Intrinsics(*(jnp.float64(v) for v in INTR))
    jdist = jcam.DistCoeffs(*(jnp.float64(v) for v in DIST))
    ref = np.asarray(jcam.undistort_points_fast(jintr, jdist,
                                                jnp.asarray(pts[:, :2])))
    view = torch.as_tensor(pts)[:, :2]
    assert not view.is_contiguous()
    out = camera.undistort_points_fast(camera.Intrinsics(*INTR),
                                       camera.DistCoeffs(*DIST), view)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)


def test_float_parameters_and_iters():
    """Plain numbers work as parameters; no Newton step leaves the
    normalized-plane start, the identity when there is no distortion."""
    px = torch.tensor([[100.0, 200.0], [367.215, 248.375]], dtype=torch.float64)
    intr = camera.Intrinsics(*INTR)
    out = camera.undistort_points_fast(intr, camera.DistCoeffs.zeros(), px)
    np.testing.assert_allclose(out.numpy(), px.numpy(), atol=1e-12)
    out0 = camera.undistort_points_fast(intr, camera.DistCoeffs(*DIST), px,
                                        iters=0)
    np.testing.assert_allclose(out0.numpy(), px.numpy(), atol=1e-12)


def test_camera_helpers_match_jax():
    """K, from_K, the OpenCV order and the single-point helpers, batched."""
    jintr = jcam.Intrinsics(*(jnp.float64(v) for v in INTR))
    jdist = jcam.DistCoeffs(*(jnp.float64(v) for v in DIST))
    intr = interop.intrinsics_from_jax(jintr, "cpu")
    dist = interop.dist_from_jax(jdist, "cpu")
    np.testing.assert_array_equal(intr.K.numpy(), np.asarray(jintr.K))
    assert camera.Intrinsics.from_K(intr.K) == tuple(intr)
    np.testing.assert_array_equal(dist.to_opencv().numpy(),
                                  np.asarray(jdist.to_opencv()))
    assert camera.DistCoeffs.from_opencv(dist.to_opencv()) == tuple(dist)
    rng = np.random.default_rng(7)
    p = rng.uniform(-0.8, 0.8, size=(50, 2))
    jp = jnp.asarray(p)
    tp = torch.as_tensor(p)
    for ours, theirs in (
            (camera.project(intr, tp), [jcam.project(jintr, q) for q in jp]),
            (camera.unproject(intr, tp), [jcam.unproject(jintr, q) for q in jp]),
            (camera.distort_normalized(dist, tp),
             [jcam.distort_normalized(jdist, q) for q in jp])):
        np.testing.assert_allclose(ours.numpy(), np.stack(theirs), rtol=0,
                                   atol=1e-12)
