"""The port's chessboard detector (slam_tricks_tpu_torch/frontend/
chessboard.py) against the JAX package's, on boards rendered from a seed
(tests/test_frontend_ops.py's recipe), in float64 on both sides:

- _prototype_kernels: the same float32-rounded taps; corner_likelihood and
  the multi-scale likelihood: 1e-12 relative;
- detect_corners: the valid candidates as a set of (row, col, score),
  scores to 1e-9, the invalid slots by count;
- refine_corners_subpixel, estimate_orientations, verify_corners,
  verify_corners_meanshift and refine_edge_directions on the JAX package's
  candidates: positions to 1e-9 px, angles to 1e-9, mode bins and
  accepted sets equal, scores to 1e-9 relative;
- mean_shift_modes on a batch of random histograms and on the boards'
  histograms: the same bins; _sector_prototype: 1e-12;
- board_energy and grow_chessboards: the JAX package's result on the same
  input;
- the JAX references of the per-candidate stages run under jax.jit (one
  compile each; eagerly their vmaps dispatch op by op);
- detect_chessboard end to end (5 x 7 interior corners, 6 x 8 squares of
  20 px, noise 0.01): the same boards as grids of corner positions (1e-9
  px), and the JAX tests' gates on the port: every true interior corner
  within 1 px, the grown board holding all 35 of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.frontend import chessboard as jcb
from slam_tricks_tpu_torch.frontend import chessboard as cb
from slam_tricks_tpu_torch.sim.images import render_chessboard
from tests.torch_util import peak_set, rel_err


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def board():
    img, truth = render_chessboard(rows=5, cols=7, square_px=20, margin=20,
                                   angle=0.15, noise=0.01, seed=11)
    img = img.astype(np.float64)
    jimg = jnp.asarray(img)
    like = jcb.corner_likelihood_multiscale(jimg, (4, 8, 12))
    s, xy = jcb.detect_corners(jimg, k=96, radii=(4, 8, 12))
    return img, truth, like, s, xy


def test_prototype_kernels_and_likelihood_match_jax(board):
    img, _, like, _, _ = board
    for radius in (4, 8):
        for angles in ((0.0, np.pi / 2), (np.pi / 4, 3 * np.pi / 4)):
            for got, want in zip(
                    cb._prototype_kernels(radius, angles, torch.float64,
                                          "cpu"),
                    jcb._prototype_kernels(radius, angles, jnp.float64)):
                assert np.array_equal(got.numpy(), np.asarray(want))
        assert rel_err(cb.corner_likelihood(T(img), radius),
                       jcb.corner_likelihood(jnp.asarray(img), radius)) < 1e-12
    assert rel_err(cb.corner_likelihood_multiscale(T(img)), like) < 1e-12


def test_detect_corners_matches_jax(board):
    img, _, _, js, jxy = board
    s, xy = cb.detect_corners(T(img), k=96, radii=(4, 8, 12))
    jxy = np.asarray(jxy).astype(np.int64)
    assert peak_set(s, xy[:, 1].long(), xy[:, 0].long()) == peak_set(
        js, jxy[:, 1], jxy[:, 0])
    assert int(torch.isinf(s).sum()) == int(np.isinf(np.asarray(js)).sum())


def test_candidate_stages_match_jax(board):
    img, _, like, js, jxy = board
    jimg = jnp.asarray(img)
    valid = np.isfinite(np.asarray(js))
    xy, s = T(jxy), T(js)
    ref = cb.refine_corners_subpixel(T(img), xy, window=6)
    jref = jax.jit(jcb.refine_corners_subpixel, static_argnames="window")(
        jimg, jxy, window=6)
    assert float(np.abs(ref.numpy() - np.asarray(jref))[valid].max()) < 1e-9
    ang, strength = cb.estimate_orientations(T(img), xy)
    jang, jstrength = jax.jit(jcb.estimate_orientations)(jimg, jxy)
    assert np.array_equal(ang.numpy()[valid], np.asarray(jang)[valid])
    assert rel_err(strength.numpy()[valid], np.asarray(jstrength)[valid]) < 1e-9
    assert np.array_equal(
        np.isfinite(cb.verify_corners(T(img), xy, s).numpy()),
        np.isfinite(np.asarray(jax.jit(jcb.verify_corners)(jimg, jxy, js))))
    sc, an = cb.verify_corners_meanshift(T(img), xy, s, T(like))
    jsc, jan = jax.jit(jcb.verify_corners_meanshift)(jimg, jxy, js, like)
    kept = np.isfinite(np.asarray(jsc))
    assert kept.sum() >= 30
    assert np.array_equal(np.isfinite(sc.numpy()), kept)
    assert rel_err(sc.numpy()[kept], np.asarray(jsc)[kept]) < 1e-9
    assert np.array_equal(an.numpy()[valid], np.asarray(jan)[valid])
    edges = cb.refine_edge_directions(T(img), T(jref), T(jan))
    jedges = jax.jit(jcb.refine_edge_directions)(jimg, jref, jan)
    assert float(np.abs(edges.numpy() - np.asarray(jedges))[kept].max()) < 1e-9


def test_mean_shift_and_sector_prototype_match_jax():
    rng = np.random.default_rng(8)
    hist = rng.gamma(0.6, size=(64, 32))
    hist[:, 5] += 4.0
    hist[:, 21] += rng.uniform(1, 5, 64)
    raw, hist = hist, np.asarray(jcb._circular_gauss_taps(jnp.asarray(hist)))
    assert rel_err(cb._circular_gauss_taps(T(raw)), hist) < 1e-15
    i1, i2 = cb.mean_shift_modes(T(hist))
    j1, j2 = jax.jit(jax.vmap(jcb.mean_shift_modes))(jnp.asarray(hist))
    assert np.array_equal(i1.numpy(), np.asarray(j1))
    assert np.array_equal(i2.numpy(), np.asarray(j2))
    a1 = rng.uniform(0, np.pi, 5)
    a2 = rng.uniform(0, np.pi, 5)
    got = cb._sector_prototype(6, T(a1), T(a2), torch.float64)
    for k in range(5):
        want = jcb._sector_prototype(6, jnp.asarray(a1[k]),
                                     jnp.asarray(a2[k]), jnp.float64)
        for g, w in zip(got, want):
            assert float(np.abs(g[k].numpy() - np.asarray(w)).max()) < 1e-12
        assert float(np.abs(cb._sobel_mag(got[0])[k].numpy() - np.asarray(
            jcb._sobel_mag(want[0]))).max()) < 1e-12


def test_board_energy_and_growth_match_jax(board):
    _, truth, _, _, _ = board
    grid = truth.reshape(7, 5, 2)
    assert cb.board_energy(grid) == jcb.board_energy(grid)
    rng = np.random.default_rng(2)
    xy = np.concatenate([truth + rng.normal(size=truth.shape) * 0.2,
                         rng.uniform(0, 300, (10, 2))])
    scores = rng.uniform(0.5, 1.0, len(xy))
    scores[-3:] = -np.inf
    got = cb.grow_chessboards(xy, None, scores)
    want = jcb.grow_chessboards(xy, None, scores)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_detect_chessboard_matches_jax(board):
    img, truth = board[:2]
    jboards, jxy, jsc, jang = jcb.detect_chessboard(jnp.asarray(img), k=96)
    boards, xy, sc, ang = cb.detect_chessboard(img, k=96, device="cpu")
    assert len(boards) == len(jboards) >= 1
    for b, jb in zip(boards, jboards):
        assert b.shape == jb.shape
        assert float(np.abs(xy.numpy()[b] - np.asarray(jxy)[jb]).max()) < 1e-9
    # tests/test_frontend_ops.py's gates, on the port
    kept = np.isfinite(sc.numpy())
    det = xy.numpy()[kept]
    best = np.linalg.norm(det[None] - truth[:, None], axis=2).min(axis=1)
    assert (best < 1.0).all(), best.max()
    grid = xy.numpy()[boards[0]]
    assert boards[0].size == len(truth)
    near = np.linalg.norm(grid.reshape(-1, 1, 2) - truth[None], axis=2)
    assert (near.min(axis=0) < 1.0).all()
