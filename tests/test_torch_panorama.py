"""The port's panorama pipeline (slam_tricks_tpu_torch/pipelines/
panorama.py) against the JAX package's, on the same seeded numpy images.
There is no common random stream (a JAX key and a torch.Generator draw
different subsets), so RANSAC is held on given subsets and on a unique
consensus: integer shifts reproduce the corners exactly, so every true
match fits with a zero residual and every false one misses.

- harris_corners (float64): the valid corners as a set, scores to 1e-9;
  patch_descriptors on the JAX package's corners: 1e-12;
  match_descriptors on its descriptors: the same indices and accepted set
  (identity and shifted pairs), and the JAX test's identity gate;
- the homography hypotheses on the same 256 subsets: fits to 1e-8
  relative, the same inlier counts;
- pairwise_homography with features "harris" and "orb" (float64): H to
  1e-6 of the JAX package's (H[2, 2] = 1), the same inlier count, and the
  JAX tests' gates (the shift within 0.5 px, more than 15 inliers; the
  ORB pan within 2 px, at least 20, also in float32);
- chain_to_middle and compose_panorama on given homographies: 1e-5;
- stitch of three crops of one texture at known shifts: its pairwise
  homographies within 1e-2 px of the JAX package's at the frame corners
  (float32, its pairwise step under jax.jit), the same inlier counts, the
  JAX test's gates; the canvas to 1e-5 of the JAX package's compose of the
  same homographies.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.pipelines import panorama as jpan
from slam_tricks_tpu_torch.pipelines import panorama as pan
from slam_tricks_tpu_torch.sim.images import (polygon_image, shift_image,
                                              textured_image)
from tests.torch_util import peak_set, rel_err

ransac = importlib.import_module("slam_tricks_tpu_torch.initialization.ransac")
SHIFT = (12.0, 5.0)
CROPS = ((0, 0), (12, 5), (24, 10))     # (x, y) of 120 x 160 crops: the
                                        # JAX test's shift, twice


def T(a):
    return torch.as_tensor(np.array(a))


_jit_pairwise = jax.jit(jpan.pairwise_homography,
                        static_argnames=("n_corners", "features"))


@pytest.fixture(scope="module")
def shifted():
    img1 = textured_image(h=140, w=180, seed=4).astype(np.float64)
    img2 = shift_image(img1, -SHIFT[0], -SHIFT[1]).astype(np.float64)
    ref = jax.block_until_ready(_jit_pairwise(
        jax.random.PRNGKey(0), jnp.asarray(img1), jnp.asarray(img2)))
    return img1, img2, ref


def test_harris_descriptors_and_matching_match_jax(shifted):
    img1, img2, _ = shifted
    s, xy = pan.harris_corners(T(img1), k=128)
    js, jxy = jpan.harris_corners(jnp.asarray(img1), k=128)
    jrc = np.asarray(jxy).astype(np.int64)
    assert peak_set(s, xy[:, 1].long(), xy[:, 0].long()) == peak_set(
        js, jrc[:, 1], jrc[:, 0])
    jd1 = jpan.patch_descriptors(jnp.asarray(img1), jxy)
    assert rel_err(pan.patch_descriptors(T(img1), T(jxy)), jd1) < 1e-12
    _, jxy2 = jpan.harris_corners(jnp.asarray(img2), k=128)
    jd2 = jpan.patch_descriptors(jnp.asarray(img2), jxy2)
    v = np.isfinite(np.asarray(js))
    for d2 in (jd1, jd2):
        idx, ok = pan.match_descriptors(T(jd1), T(d2), valid1=T(v),
                                        valid2=T(v))
        jidx, jok = jpan.match_descriptors(jd1, d2, valid1=jnp.asarray(v),
                                           valid2=jnp.asarray(v))
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        assert np.array_equal(ok.numpy(), np.asarray(jok))
    idx, _ = pan.match_descriptors(T(jd1), T(jd1))
    assert (idx.numpy()[v] == np.arange(len(v))[v]).mean() > 0.9


def _match_data(img1, img2):
    """pairwise_homography's RANSAC data, from the JAX package's features."""
    s1, xy1 = jpan.harris_corners(jnp.asarray(img1), 256)
    s2, xy2 = jpan.harris_corners(jnp.asarray(img2), 256)
    idx, ok = jpan.match_descriptors(
        jpan.patch_descriptors(jnp.asarray(img1), xy1),
        jpan.patch_descriptors(jnp.asarray(img2), xy2),
        valid1=jnp.isfinite(s1), valid2=jnp.isfinite(s2))
    return {"src": np.asarray(xy1), "dst": np.asarray(xy2)[np.asarray(idx)],
            "w": np.asarray(ok).astype(np.float64)}


def test_homography_hypotheses_match_jax_on_the_same_subsets(shifted):
    from slam_tricks_tpu.initialization.homography import homography_dlt

    data = _match_data(*shifted[:2])
    w = T(data["w"])
    idx = ransac.draw_subsets(torch.Generator().manual_seed(5), 256, 256, 5,
                              sample_weights=w)
    d = {k: T(v) for k, v in data.items()}
    params, scores = ransac.hypothesis_scores(
        d, idx, min_fit=pan.homography_min_fit,
        residual_sq=pan.homography_residual_sq, inlier_thresh_sq=4.0)
    jd = {k: jnp.asarray(v) for k, v in data.items()}

    def jfit(i):
        sub = jax.tree_util.tree_map(lambda a: a[i], jd)
        return homography_dlt(sub["src"], sub["dst"], sub["w"]).reshape(-1)

    def jres(p):
        pred = jpan.apply_h(p.reshape(3, 3), jd["src"])
        r2 = jnp.sum((pred - jd["dst"]) ** 2, axis=1)
        return jnp.where(jd["w"] > 0, r2, jnp.inf)

    jparams = jax.jit(jax.vmap(jfit))(jnp.asarray(idx.numpy()))
    jscores = jnp.sum(jax.vmap(jres)(jparams) < 4.0, axis=1)
    assert rel_err(params, jparams) < 1e-8
    assert np.array_equal(scores.numpy(), np.asarray(jscores))
    assert int(scores.max()) > 15


def test_pairwise_homography_harris_matches_jax(shifted):
    img1, img2, (jH, jn) = shifted
    H, n_in = pan.pairwise_homography(torch.Generator().manual_seed(0),
                                      T(img1), T(img2))
    assert int(n_in) == int(jn) > 15
    assert float(np.abs(H.numpy() - np.asarray(jH)).max()) < 1e-6
    H = H.numpy() / H.numpy()[2, 2]
    assert abs(H[0, 2] + SHIFT[0]) < 0.5 and abs(H[1, 2] + SHIFT[1]) < 0.5


def test_pairwise_homography_orb_matches_jax():
    """tests/test_orb.py's ORB pan, a 40-px translation: float64 on both
    sides for the parity (an f32 DLT's eigh differs between LAPACK and XLA
    by ~1e-3 px), the JAX test's gate on the port in float32."""
    img = polygon_image(seed=9)
    moved = np.zeros_like(img)
    moved[:, :-40] = img[:, 40:]
    img, moved = img.astype(np.float64), moved.astype(np.float64)
    jH, jn = jax.block_until_ready(_jit_pairwise(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(moved),
        n_corners=256, features="orb"))
    H, n_in = pan.pairwise_homography(torch.Generator().manual_seed(0),
                                      T(img), T(moved), n_corners=256,
                                      features="orb")
    assert int(n_in) == int(jn) >= 20
    assert float(np.abs(H.numpy() - np.asarray(jH)).max()) < 1e-6
    H, n_in = pan.pairwise_homography(
        torch.Generator().manual_seed(0), T(img.astype(np.float32)),
        T(moved.astype(np.float32)), n_corners=256, features="orb")
    assert int(n_in) >= 20
    pt = pan.apply_h(H, torch.tensor([[160.0, 120.0]])).numpy()
    np.testing.assert_allclose(pt, [[120.0, 120.0]], atol=2.0)


def test_chain_and_compose_match_jax():
    Hs = [np.diag([1.0, 1, 1]), np.diag([2.0, 2, 1])]
    chained = pan.chain_to_middle(Hs)
    for g, w in zip(chained, jpan.chain_to_middle(Hs)):
        assert np.array_equal(g, w)
    assert np.allclose(chained[1], np.eye(3))
    base = textured_image(h=60, w=90, seed=2)
    images = [base[:, :60], base[:, 15:75], base[:, 30:]]
    Hs = [np.array([[1.0, 0, 15], [0, 1, 0], [0, 0, 1]]), np.eye(3),
          np.array([[1.02, 0.01, -15], [0, 0.99, 0.5], [1e-5, 0, 1]])]
    canvas, cover = pan.compose_panorama(images, Hs, device="cpu")
    jcanvas, jcover = jpan.compose_panorama(images, Hs)
    assert np.array_equal(cover.numpy(), np.asarray(jcover))
    assert float(np.abs(canvas.numpy() - np.asarray(jcanvas)).max()) < 1e-5


def test_stitch_matches_jax():
    """stitch's three pairwise homographies (float32, as stitch makes them)
    against the JAX package's on the same crops: within 1e-2 px at the
    frame corners, the same inlier counts, and each the crops' shift (the
    JAX test's gate). The canvas against the JAX package's compose of the
    same homographies (a canvas's size is the floor and ceiling of its
    corners, so it follows H's last bits): the same coverage, 1e-5."""
    base = textured_image(h=130, w=184, seed=6)
    images = [base[y:y + 120, x:x + 160] for x, y in CROPS]
    canvas, cover = pan.stitch(images, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)      # stitch's draws, replayed
    key = jax.random.PRNGKey(0)               # the JAX package's stitch's
    corners = torch.tensor([[0.0, 0], [160, 0], [0, 120], [160, 120]])
    Hs = []
    for (x0, y0), (x1, y1), a, b in zip(CROPS, CROPS[1:], images, images[1:]):
        key, k = jax.random.split(key)
        jH, jn = _jit_pairwise(k, jnp.asarray(a), jnp.asarray(b))
        H, n_in = pan.pairwise_homography(g, T(a), T(b))
        assert int(n_in) == int(jn) > 15
        assert float((pan.apply_h(H, corners) - pan.apply_h(T(jH), corners))
                     .abs().max()) < 1e-2
        Hn = H.numpy() / H.numpy()[2, 2]
        assert abs(Hn[0, 2] + (x1 - x0)) < 0.5
        assert abs(Hn[1, 2] + (y1 - y0)) < 0.5
        Hs.append(H.numpy())
    jcanvas, jcover = jpan.compose_panorama(images, jpan.chain_to_middle(Hs))
    assert canvas.shape == jcanvas.shape
    assert np.array_equal(cover.numpy(), np.asarray(jcover))
    assert float(np.abs(canvas.numpy() - np.asarray(jcanvas)).max()) < 1e-5


def test_entry_points_default_to_the_card():
    """Called without a device, the front end's entry points that make
    tensors put them on the card; with no card they raise, never fall back
    to the CPU."""
    from slam_tricks_tpu_torch.frontend.chessboard import detect_chessboard
    from slam_tricks_tpu_torch.sim.distortion import box_segments

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    img = textured_image(h=60, w=80, seed=1)
    for call in (lambda: pan.stitch([img, img]),
                 lambda: pan.compose_panorama([img], [np.eye(3)]),
                 lambda: detect_chessboard(img.astype(np.float64)),
                 lambda: box_segments(4.0)):
        with pytest.raises((AssertionError, RuntimeError)):
            call()
