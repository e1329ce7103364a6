"""The port's ORB features (slam_tricks_tpu_torch/frontend/orb.py) against
the JAX package's, on the same seeded numpy images (random filled polygons
and their 30-degree rotation, made with numpy and scipy, no cv2):

- _pattern: the same test pairs bit for bit;
- _fast_mask (float32 and float64): the same mask; _harris_response and
  _centroid_moments (float64): 1e-12 relative;
- orb_detect (n 300, float64): the valid keypoints as a set of (row, col,
  score), scores to 1e-9, the invalid slots by count (moved to (16, 16) in
  both); angles to 1e-9 at every valid keypoint; descriptor bits equal
  wherever the two samples of a test differ by more than 1e-9, and the
  bits within that margin counted (at most 0.5% of them);
- orb_match on the JAX package's features (both images, float32): the
  same indices and the same accepted set, at two ratio and Hamming
  settings;
- tests/test_orb.py's gates on the port in float32: more than 80 valid
  features inside the 16-px border, and across the 30-degree rotation at
  least 30 matches, more than 70% within 3 px of the known map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.frontend import orb as jorb
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.frontend import orb
from slam_tricks_tpu_torch.ops.image import gaussian_blur, sample_bilinear
from slam_tricks_tpu_torch.sim.images import polygon_image, rotate_image
from tests.torch_util import peak_set, rel_err


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def pair():
    img = polygon_image(seed=3)
    rot, M = rotate_image(img, 30.0)
    return img, rot, M


@pytest.fixture(scope="module")
def jax_features(pair):
    img, rot, _ = pair
    f64 = jorb.orb_detect(jnp.asarray(img, jnp.float64), n=300)
    f1 = jorb.orb_detect(jnp.asarray(img), n=300)
    f2 = jorb.orb_detect(jnp.asarray(rot), n=300)
    return f64, f1, f2


def test_pattern_is_the_jax_pattern():
    assert np.array_equal(orb._pattern(), jorb._pattern())
    assert np.array_equal(orb._PATTERN, jorb._PATTERN)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fast_mask_matches_jax(pair, dtype):
    img = pair[0].astype(dtype)
    for thresh in (0.02, 0.04):
        got = orb._fast_mask(T(img), torch.tensor(thresh, dtype=T(img).dtype))
        want = np.asarray(jorb._fast_mask(jnp.asarray(img),
                                          jnp.asarray(thresh, dtype)))
        assert got.sum() > 50
        assert np.array_equal(got.numpy(), want)


def test_harris_and_moments_match_jax(pair):
    img = pair[0].astype(np.float64)
    assert rel_err(orb._harris_response(T(img)),
                   jorb._harris_response(jnp.asarray(img))) < 1e-12
    for got, want in zip(orb._centroid_moments(T(img)),
                         jorb._centroid_moments(jnp.asarray(img))):
        assert rel_err(got, want) < 1e-12


def _test_margin(img, f):
    """|va - vb| of each descriptor test at the port's keypoints: a bit is
    only defined up to the rounding of its two samples."""
    smooth = gaussian_blur(img, 2.0)
    pat = torch.as_tensor(orb._PATTERN, dtype=img.dtype)
    ca, sa = torch.cos(f.angle), torch.sin(f.angle)
    R = torch.stack([torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)],
                    -2)
    pts = torch.einsum("nij,btj->nbti", R, pat)
    va = sample_bilinear(smooth, f.xy[:, None] + pts[:, :, 0])
    vb = sample_bilinear(smooth, f.xy[:, None] + pts[:, :, 1])
    return (va - vb).abs()


def test_orb_detect_matches_jax(pair, jax_features):
    img = T(pair[0].astype(np.float64))
    jf = jax_features[0]
    f = orb.orb_detect(img, n=300)
    rows, cols = f.xy[:, 1].long(), f.xy[:, 0].long()
    jxy = np.asarray(jf.xy).astype(np.int64)
    assert peak_set(f.score, rows, cols) == peak_set(jf.score, jxy[:, 1],
                                                     jxy[:, 0])
    valid = f.valid.numpy()
    assert int((~valid).sum()) == int((~np.asarray(jf.valid)).sum())
    assert (f.xy.numpy()[~valid] == orb._PATCH + 1).all()
    assert (f.desc.numpy()[~valid] == 0).all()
    # the same keypoint, row by row of the JAX package's order
    key = {(int(x), int(y)): i for i, (x, y) in enumerate(f.xy.long().tolist())}
    idx = np.array([key[(int(x), int(y))] for x, y in jxy[np.asarray(jf.valid)]])
    jvalid = np.asarray(jf.valid)
    assert float(np.abs(f.angle.numpy()[idx] - np.asarray(jf.angle)[jvalid])
                 .max()) < 1e-9
    margin = _test_margin(img, f).numpy()[idx]
    desc, jdesc = f.desc.numpy()[idx], np.asarray(jf.desc)[jvalid]
    clear = margin > 1e-9
    assert np.array_equal(desc[clear], jdesc[clear])
    assert (~clear).mean() < 5e-3, (~clear).mean()


@pytest.mark.parametrize("ratio, max_hamming", [(0.8, 48), (0.9, 64)])
def test_orb_match_matches_jax(jax_features, ratio, max_hamming):
    _, jf1, jf2 = jax_features
    idx, ok = orb.orb_match(interop.orb_features_from_jax(jf1, "cpu"),
                            interop.orb_features_from_jax(jf2, "cpu"),
                            ratio=ratio, max_hamming=max_hamming)
    jidx, jok = jorb.orb_match(jf1, jf2, ratio=ratio, max_hamming=max_hamming)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert int(ok.sum()) >= 30


def test_orb_gates_on_the_port(pair):
    """tests/test_orb.py's detection and rotation-matching gates."""
    img, rot, M = pair
    f1 = orb.orb_detect(T(img), n=300)
    f2 = orb.orb_detect(T(rot), n=300)
    assert int(f1.valid.sum()) > 80
    xy = f1.xy.numpy()[f1.valid.numpy()]
    assert xy[:, 0].min() >= 16 and xy[:, 0].max() < img.shape[1] - 16
    idx2, ok = orb.orb_match(f1, f2, ratio=0.8, max_hamming=48)
    ok = ok.numpy()
    assert ok.sum() >= 30, int(ok.sum())
    pred = f1.xy.numpy()[ok] @ M[:, :2].T + M[:, 2]
    err = np.linalg.norm(pred - f2.xy.numpy()[idx2.numpy()[ok]], axis=1)
    assert (err < 3.0).mean() > 0.7, (float((err < 3.0).mean()),
                                      float(np.median(err)))
