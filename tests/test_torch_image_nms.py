"""The port's image ops and NMS (slam_tricks_tpu_torch/ops/image.py,
ops/nms.py) against the JAX package's, on the same seeded numpy inputs, in
float64 on both sides:

- sample_nearest and sample_bilinear on (H, W) and (H, W, 3) images at
  points inside, on and outside the border: 1e-12;
- undistort_image, bilinear and nearest, on a rendered board (float64 and
  float32, whose output is cast back): 1e-12 (float64), 1e-6 (float32);
- conv2d with odd and even kernels ("SAME" padding), gaussian_kernel1d,
  gaussian_blur and sobel: 1e-12 relative; Sobel's gradient direction;
- nms1d and nms2d (tests/test_frontend_ops.py's inputs and a random
  image): the same masks; top_k_peaks: the valid peaks as a set of (row,
  col, score) with scores to 1e-12, the invalid slots by count, and on a
  plateau-free image the same slots in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.ops import image as jim
from slam_tricks_tpu.ops import nms as jnms
from slam_tricks_tpu.residuals.camera import DistCoeffs as JDist
from slam_tricks_tpu.residuals.camera import Intrinsics as JIntr
from slam_tricks_tpu_torch.ops import image as im
from slam_tricks_tpu_torch.ops import nms
from slam_tricks_tpu_torch.residuals.camera import DistCoeffs, Intrinsics
from slam_tricks_tpu_torch.sim.images import render_chessboard
from tests.torch_util import peak_set, rel_err

RNG = np.random.default_rng(41)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("channels", [None, 3])
def test_samplers_match_jax(channels):
    shape = (24, 31) if channels is None else (24, 31, channels)
    img = RNG.normal(size=shape)
    xy = np.concatenate([RNG.uniform([-3, -3], [34, 27], (200, 2)),
                         [[0, 0], [30, 23], [29.5, 22.5], [30.0, 0.2]]])
    for f, jf in ((im.sample_bilinear, jim.sample_bilinear),
                  (im.sample_nearest, jim.sample_nearest)):
        got = f(T(img), T(xy))
        want = np.asarray(jf(jnp.asarray(img), jnp.asarray(xy)))
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) < 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_undistort_image_matches_jax(dtype, interpolation):
    img, _ = render_chessboard(rows=4, cols=5, angle=0.0)
    img = img.astype(dtype)
    H, W = img.shape
    k = (W / 2, W / 2, W / 2, H / 2)
    d = (-0.2, 0.05, 0.01, 1e-3, -2e-3)
    want = np.asarray(jim.undistort_image(
        jnp.asarray(img), JIntr(*(jnp.asarray(v, dtype) for v in k)),
        JDist(*(jnp.asarray(v, dtype) for v in d)), interpolation))
    got = im.undistort_image(T(img), Intrinsics(*k), DistCoeffs(*d),
                             interpolation)
    assert got.dtype == torch.from_numpy(img).dtype
    assert got.shape == img.shape and np.isfinite(got.numpy()).all()
    tol = 1e-12 if dtype == np.float64 else 1e-6
    assert float(np.abs(got.numpy() - want).max()) < tol


@pytest.mark.parametrize("ksize", [(3, 3), (5, 1), (1, 7), (4, 6), (31, 31)])
def test_conv2d_matches_jax(ksize):
    img = RNG.normal(size=(40, 52))
    ker = RNG.normal(size=ksize)
    assert rel_err(im.conv2d(T(img), T(ker)),
                   jim.conv2d(jnp.asarray(img), jnp.asarray(ker))) < 1e-12


def test_filters_match_jax():
    img = RNG.uniform(size=(48, 64))
    for sigma in (1.0, 1.5, 2.0):
        assert rel_err(im.gaussian_kernel1d(sigma, dtype=torch.float64,
                                            device="cpu"),
                       jim.gaussian_kernel1d(sigma, dtype=jnp.float64)) < 1e-14
        assert rel_err(im.gaussian_blur(T(img), sigma),
                       jim.gaussian_blur(jnp.asarray(img), sigma)) < 1e-12
    for got, want in zip(im.sobel(T(img)), jim.sobel(jnp.asarray(img))):
        assert rel_err(got, want) < 1e-12
    ramp = T(np.tile(np.linspace(0, 1, 32), (32, 1)))
    gx, gy = im.sobel(ramp)
    assert float(gx[:, 2:-2].mean()) > 0
    assert abs(float(gy[2:-2, :].mean())) < 1e-12


def test_nms_masks_match_jax():
    x = np.asarray([0.0, 1.0, 0.5, 0.2, 2.0, 1.9, 0.0, 3.0])
    assert np.array_equal(nms.nms1d(T(x), 1).numpy(),
                          np.asarray(jnms.nms1d(jnp.asarray(x), 1)))
    one = np.zeros((32, 32))
    one[10, 12], one[10, 13] = 5.0, 4.0
    mask = nms.nms2d(T(one), 2, threshold=0.5).numpy()
    assert mask[10, 12] and not mask[10, 13] and mask.sum() == 1
    img = RNG.normal(size=(40, 56))
    for r in (1, 3, 6):
        assert np.array_equal(nms.nms1d(T(img[0]), r).numpy(),
                              np.asarray(jnms.nms1d(jnp.asarray(img[0]), r)))
        for thr in (None, 0.5):
            assert np.array_equal(
                nms.nms2d(T(img), r, thr).numpy(),
                np.asarray(jnms.nms2d(jnp.asarray(img), r, thr)))


def test_top_k_peaks_matches_jax():
    img = np.zeros((64, 64))
    for r, c, v in [(5, 7, 3.0), (20, 40, 2.0), (50, 22, 1.0)]:
        img[r, c] = v
    # a zero plateau: the 3 peaks, then k - 3 invalid slots
    got = nms.top_k_peaks(T(img), 5, 3, 0.5)
    want = jnms.top_k_peaks(jnp.asarray(img), 5, 3, 0.5)
    assert peak_set(*got) == peak_set(*want) == {(5, 7, 3.0), (20, 40, 2.0),
                                                 (50, 22, 1.0)}
    assert int(torch.isinf(got[0]).sum()) == int(np.isinf(want[0]).sum()) == 2
    # a random image: the same slots in the same order
    img = RNG.normal(size=(48, 60))
    for k, r, thr in ((40, 2, -np.inf), (200, 3, 0.0), (64, 5, 1.0)):
        s, rows, cols = nms.top_k_peaks(T(img), k, r, thr)
        js, jrows, jcols = jnms.top_k_peaks(jnp.asarray(img), k, r, thr)
        valid = np.isfinite(np.asarray(js))
        assert np.array_equal(np.isfinite(s.numpy()), valid)
        assert np.array_equal(rows.numpy()[valid], np.asarray(jrows)[valid])
        assert np.array_equal(cols.numpy()[valid], np.asarray(jcols)[valid])
        assert float(np.abs(s.numpy()[valid] - np.asarray(js)[valid]).max()
                     ) < 1e-12
