"""The port's initialization solvers (slam_tricks_tpu_torch/initialization)
against the JAX package's, on the same seeded numpy inputs, in f64.

Eigen- and singular vectors carry a free sign, and E's two equal singular
values a free rotation of their vectors: null vectors, F and E are
compared up to sign, decompose_essential's four candidates as a set; the
recovered (R, t) are unique and compared directly. Tolerances (max
|a - b| / max |b|): 1e-10 for the closed forms and the F / E / H fits
(eigh of a squared system keeps ~half the digits of its smallest
eigenvalue's gap), 1e-9 for pose recovery and triangulated points.

- eightpoint: nullvec_normal, hartley_normalize, fundamental_8pt (with
  weights, a batch of weight vectors, and a degenerate configuration: the
  identity and ok False), essential_from_fundamental, essential_8pt,
  decompose_essential, triangulate_midpoint (near-parallel rays too),
  recover_pose;
- homography: homography_dlt (with weights; a batch of views against one
  board), apply_h;
- triangulation: triangulate_nview_dlt, refine_point_gn,
  triangulate_tracks and tracks_from_obs on a small cube-room scene;
- ransac: the hypotheses' fits and scores on the same index sets as the
  JAX package's min_fit / residual_sq; ransac and ransac_iterative_refit
  on the 50%-outlier parabola of tests/test_initialization.py (a unique
  consensus: the same refit params to 1e-10 and inlier mask); the draws
  (no repeats; sample weights exclude rows);
- robust_epipolar: the hypotheses' fits and scores on the same subsets;
  robust_fundamental on tests/test_robust_epipolar.py's scene (80
  matches, 20 corrupted; the same mask, E up to sign to 1e-8, its gates);
  the median on an even count against jnp.median;
- zhang: intrinsics_from_homographies, extrinsics_from_homography and
  calibrate_closed_form on make_calib_scene(n_views=8, seed=5).
"""

import importlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.initialization import eightpoint as jep
from slam_tricks_tpu.initialization import homography as jhom
from slam_tricks_tpu.initialization import robust_epipolar as jrob
from slam_tricks_tpu.initialization import triangulation as jtri
from slam_tricks_tpu.initialization import zhang as jzhang
from slam_tricks_tpu.residuals import simple as jsimple
from slam_tricks_tpu.sim import ba_scene as jba
from slam_tricks_tpu.sim.calib_scene import make_calib_scene as jcalib_scene
from slam_tricks_tpu.sim.two_view import make_two_view as jtwo_view
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.initialization import (eightpoint, homography,
                                                  robust_epipolar,
                                                  triangulation, zhang)
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.residuals import simple
from tests.torch_util import rel_err

# the modules, which both packages' __init__ shadow with the function
jransac = importlib.import_module("slam_tricks_tpu.initialization.ransac")
ransac = importlib.import_module("slam_tricks_tpu_torch.initialization.ransac")


def T(a):
    return torch.as_tensor(np.array(a))


def rel_up_to_sign(a, b):
    return min(rel_err(a, b), rel_err(-a, b))


@pytest.fixture(scope="module")
def scene():
    s = jtwo_view(n_points=60, noise=1e-4, seed=4)
    return s, interop.two_view_from_jax(s, "cpu")


def test_nullvec_and_hartley(scene):
    js, ts = scene
    A = np.random.default_rng(0).normal(size=(40, 9))
    v, sv = eightpoint.nullvec_normal(T(A))
    jv, jsv = jep.nullvec_normal(jnp.asarray(A))
    assert rel_up_to_sign(v, jv) < 1e-10 and rel_err(sv, jsv) < 1e-12
    n, Tm = eightpoint.hartley_normalize(ts.uv1)
    jn, jT = jep.hartley_normalize(js.uv1)
    assert rel_err(n, jn) < 1e-13 and rel_err(Tm, jT) < 1e-13
    nb, Tb = eightpoint.hartley_normalize(torch.stack([ts.uv1, ts.uv2]))
    assert rel_err(nb[1], jep.hartley_normalize(js.uv2)[0]) < 1e-13
    assert Tb.shape == (2, 3, 3)


def test_fundamental_and_essential(scene):
    js, ts = scene
    w = np.random.default_rng(1).uniform(0.2, 1.0, 60)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else T(weights)
        jF, jok = jep.fundamental_8pt(js.uv1, js.uv2, jw, return_ok=True)
        F, ok = eightpoint.fundamental_8pt(ts.uv1, ts.uv2, tw, return_ok=True)
        assert bool(ok) and bool(jok)
        assert rel_up_to_sign(F, jF) < 1e-10
        jE = jep.essential_8pt(js.uv1, js.uv2, jw)
        E = eightpoint.essential_8pt(ts.uv1, ts.uv2, tw)
        assert rel_up_to_sign(E, jE) < 1e-10
    # a batch of weight vectors: one fit each
    W = np.random.default_rng(2).uniform(0.2, 1.0, (3, 60))
    Fb = eightpoint.fundamental_8pt(ts.uv1, ts.uv2, T(W))
    for i in range(3):
        assert rel_up_to_sign(Fb[i], jep.fundamental_8pt(
            js.uv1, js.uv2, jnp.asarray(W[i]))) < 1e-10
    K1 = np.array([[500.0, 0, 320], [0, 490, 240], [0, 0, 1]])
    K2 = np.array([[510.0, 0, 310], [0, 505, 250], [0, 0, 1]])
    Fn = np.asarray(jep.fundamental_8pt(js.uv1, js.uv2))
    assert rel_err(eightpoint.essential_from_fundamental(T(Fn), T(K1), T(K2)),
                   jep.essential_from_fundamental(jnp.asarray(Fn),
                                                  jnp.asarray(K1),
                                                  jnp.asarray(K2))) < 1e-13


def test_fundamental_degenerate_gives_identity():
    """Collinear points, and one point repeated: no unique null space."""
    rng = np.random.default_rng(3)
    p1 = rng.uniform(-1, 1, size=(20, 2))
    p1[:, 1] = 0.5 * p1[:, 0]
    same = np.tile([[0.3, -0.2]], (12, 1))
    for a, b in ((p1, 1.3 * p1), (same, same + 0.1)):
        jF, jok = jep.fundamental_8pt(jnp.asarray(a), jnp.asarray(b),
                                      return_ok=True)
        F, ok = eightpoint.fundamental_8pt(T(a), T(b), return_ok=True)
        assert not bool(jok) and not bool(ok)
        assert torch.equal(F, torch.eye(3, dtype=torch.float64))


def test_decompose_essential_as_a_set(scene):
    js, ts = scene
    E = np.asarray(jep.essential_8pt(js.uv1, js.uv2))
    Rs, tv = eightpoint.decompose_essential(T(E))
    jRs, jts = jep.decompose_essential(jnp.asarray(E))
    assert Rs.shape == (4, 3, 3) and tv.shape == (4, 3)
    dets = torch.linalg.det(Rs)
    assert float((dets - 1).abs().max()) < 1e-12
    jRs, jts = np.asarray(jRs), np.asarray(jts)
    for i in range(4):
        errs = [max(np.abs(Rs[i].numpy() - jRs[j]).max(),
                    np.abs(tv[i].numpy() - jts[j]).max()) for j in range(4)]
        assert min(errs) < 1e-10, errs


def test_triangulate_midpoint(scene):
    js, ts = scene
    ref = jax.vmap(lambda a, b: jep.triangulate_midpoint(
        js.T_12.R, js.T_12.t, a, b))(js.uv1, js.uv2)
    got = eightpoint.triangulate_midpoint(ts.T_12.R, ts.T_12.t, ts.uv1,
                                          ts.uv2)
    for a, b in zip(got, ref):
        assert rel_err(a, b) < 1e-12
    # parallel rays: finite X, both depths -1
    X, d1, d2 = eightpoint.triangulate_midpoint(
        torch.eye(3, dtype=torch.float64),
        T([1.0, 0, 0]), T([0.1, 0.2]), T([0.1, 0.2]))
    jX, jd1, jd2 = jep.triangulate_midpoint(
        jnp.eye(3), jnp.asarray([1.0, 0, 0]), jnp.asarray([0.1, 0.2]),
        jnp.asarray([0.1, 0.2]))
    assert float(d1) == float(jd1) == -1.0 and float(d2) == float(jd2) == -1.0
    assert rel_err(X, jX) < 1e-13


def test_recover_pose(scene):
    js, ts = scene
    jE = jep.essential_8pt(js.uv1, js.uv2)
    ref = jep.recover_pose(jE, js.uv1, js.uv2)
    for E in (T(jE), -T(jE)):           # either sign of E gives one pose
        R, t, n_good, X = eightpoint.recover_pose(E, ts.uv1, ts.uv2)
        assert rel_err(R, ref[0]) < 1e-9 and rel_err(t, ref[1]) < 1e-9
        assert float(n_good) == float(ref[2]) == 60.0
        assert rel_err(X, ref[3]) < 1e-9
    t_ref = ts.T_12.t / ts.T_12.t.norm()
    assert float((R - ts.T_12.R).abs().max()) < 2e-3
    assert float((t - t_ref).abs().max()) < 2e-3


def test_homography_dlt_and_apply():
    rng = np.random.default_rng(4)
    H_true = np.array([[1.1, 0.05, 20.0], [-0.03, 0.97, -10.0],
                       [1e-4, -5e-5, 1.0]])
    src = rng.uniform(0, 500, size=(30, 2))
    dsth = np.concatenate([src, np.ones((30, 1))], 1) @ H_true.T
    dst = dsth[:, :2] / dsth[:, 2:] + rng.normal(size=(30, 2)) * 0.1
    w = rng.uniform(0.3, 1.0, 30)
    for weights in (None, w):
        ref = jhom.homography_dlt(jnp.asarray(src), jnp.asarray(dst),
                                  None if weights is None
                                  else jnp.asarray(weights))
        H = homography.homography_dlt(T(src), T(dst), None if weights is None
                                      else T(weights))
        assert float(H[2, 2]) == 1.0 and rel_err(H, ref) < 1e-10
    assert rel_err(homography.apply_h(H, T(src)),
                   jhom.apply_h(ref, jnp.asarray(src))) < 1e-13
    # one board against a batch of views (calibrate_closed_form's call)
    views = np.stack([dst, dst[::-1] + 3.0])
    Hb = homography.homography_dlt(T(src), T(views))
    for i in range(2):
        assert rel_err(Hb[i], jhom.homography_dlt(
            jnp.asarray(src), jnp.asarray(views[i]))) < 1e-10


@pytest.fixture(scope="module")
def small_ba():
    js = jba.make_scene(n_per_wall=20, n_cams=8, pix_noise=1e-3, seed=3)
    return js, interop.obs_from_jax(js.obs, "cpu"), interop.poses_from_jax(
        js.poses_true, "cpu")


def test_triangulation_matches_jax(small_ba):
    js, obs, poses = small_ba
    jc, juv, jw = jtri.tracks_from_obs(js.obs, js.n_points)
    c, uv, w = triangulation.tracks_from_obs(obs, js.n_points)
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert rel_err(uv, juv) == 0.0 and rel_err(w, jw) == 0.0
    c4, _, _ = triangulation.tracks_from_obs(obs, js.n_points, max_track=4)
    assert c4.shape == (js.n_points, 4)
    ref = jax.jit(jtri.triangulate_tracks)(js.poses_true, jc, juv, jw)
    X, rms = triangulation.triangulate_tracks(poses, c, uv, w)
    assert rel_err(X, ref[0]) < 1e-9 and rel_err(rms, ref[1]) < 1e-9
    # one landmark through the DLT and the refinement alone
    P = se3.SE3(poses.R[c[5].long()], poses.t[c[5].long()])
    jP = jax.tree_util.tree_map(lambda a: a[jc[5]], js.poses_true)
    jX0, jr0 = jtri.triangulate_nview_dlt(jP, juv[5], jw[5])
    X0, r0 = triangulation.triangulate_nview_dlt(P, uv[5], w[5])
    assert rel_err(X0, jX0) < 1e-10 and rel_err(r0, jr0) < 1e-9
    assert rel_err(triangulation.refine_point_gn(P, uv[5], w[5], X0, 3),
                   jtri.refine_point_gn(jP, juv[5], jw[5], jX0, 3)) < 1e-10
    seen = w.sum(dim=1) > 0
    assert float((X - interop.tensor(js.points_true, "cpu"))[seen].abs()
                 .max()) < 0.05


def _parabola_data():
    """tests/test_initialization.py's 50%-outlier parabola."""
    rng = np.random.default_rng(7)
    xs = rng.uniform(-3, 3, 300)
    clean = xs ** 2 + 2 * xs + 3
    outlier = rng.random(300) < 0.5
    ys = np.where(outlier, clean + rng.uniform(-30, 30, 300), clean)
    return xs, ys, outlier


def _jfns():
    return dict(
        min_fit=lambda d: jsimple.parabola_fit_lsq(d["x"], d["y"]),
        residual_sq=lambda p, d: jsimple.parabola_residual(
            p, d["x"], d["y"]) ** 2,
        refit=lambda d, w: jsimple.parabola_fit_lsq(d["x"], d["y"], w))


def _fns():
    return dict(
        min_fit=lambda d: simple.parabola_fit_lsq(d["x"], d["y"]),
        residual_sq=lambda p, d: simple.parabola_residual(
            p, d["x"], d["y"]) ** 2,
        refit=lambda d, w: simple.parabola_fit_lsq(d["x"], d["y"], w))


def test_ransac_hypotheses_match_jax_on_the_same_subsets():
    xs, ys, _ = _parabola_data()
    g = torch.Generator().manual_seed(3)
    idx = ransac.draw_subsets(g, 300, 64, 3)
    params, scores = ransac.hypothesis_scores(
        {"x": T(xs), "y": T(ys)}, idx, min_fit=_fns()["min_fit"],
        residual_sq=_fns()["residual_sq"], inlier_thresh_sq=0.01)
    jd = {"x": jnp.asarray(xs), "y": jnp.asarray(ys)}
    jf = _jfns()
    jparams = jax.vmap(lambda i: jf["min_fit"](
        jax.tree_util.tree_map(lambda a: a[i], jd)))(jnp.asarray(idx.numpy()))
    jr2 = jax.vmap(lambda p: jf["residual_sq"](p, jd))(jparams)
    jscores = jnp.sum(jr2 < 0.01, axis=1)
    assert rel_err(params, jparams) < 1e-10
    assert np.array_equal(scores.numpy(), np.asarray(jscores))


class LineData(NamedTuple):
    x: object
    y: object


def test_ransac_takes_namedtuple_data():
    """data as a two-field NamedTuple (the JAX ransac maps any pytree; the
    port used to rebuild it from a generator and raise TypeError): a line
    fit with 30% outliers, held to the JAX package's fits and inlier counts
    on the same subsets (params to 1e-10, counts exact), then a whole
    ransac whose consensus is unique: the JAX result to 1e-10."""
    rng = np.random.default_rng(12)
    xs = rng.uniform(-2, 2, 120)
    ys = 0.7 * xs - 0.4 + np.where(rng.random(120) < 0.3,
                                   rng.uniform(-5, 5, 120), 0.0)

    def fit(x, y, w=None):
        w = torch.ones_like(x) if w is None else w
        A = torch.stack([x * w, w], dim=1)
        return torch.linalg.lstsq(A, (y * w)[:, None]).solution[:, 0]

    def jfit(x, y, w=None):
        w = jnp.ones_like(x) if w is None else w
        return jnp.linalg.lstsq(jnp.stack([x * w, w], axis=1), y * w)[0]

    def fns(fit):
        return dict(
            min_fit=lambda d: fit(d.x, d.y),
            residual_sq=lambda p, d: (p[0] * d.x + p[1] - d.y) ** 2,
            refit=lambda d, w: fit(d.x, d.y, w))

    d = LineData(T(xs), T(ys))
    jd = LineData(jnp.asarray(xs), jnp.asarray(ys))
    idx = ransac.draw_subsets(torch.Generator().manual_seed(4), 120, 32, 2)
    params, scores = ransac.hypothesis_scores(
        d, idx, min_fit=fns(fit)["min_fit"],
        residual_sq=fns(fit)["residual_sq"], inlier_thresh_sq=1e-4)
    jf = fns(jfit)
    jparams = jax.vmap(lambda i: jf["min_fit"](
        jax.tree_util.tree_map(lambda a: a[i], jd)))(jnp.asarray(idx.numpy()))
    jscores = jnp.sum(jax.vmap(lambda p: jf["residual_sq"](p, jd))(jparams)
                      < 1e-4, axis=1)
    assert rel_err(params, jparams) < 1e-10
    assert np.array_equal(scores.numpy(), np.asarray(jscores))
    res = ransac.ransac(torch.Generator().manual_seed(0), d, subset_size=2,
                        n_hyps=64, inlier_thresh_sq=1e-4, **fns(fit))
    ref = jransac.ransac(jax.random.PRNGKey(0), jd, subset_size=2, n_hyps=64,
                         inlier_thresh_sq=1e-4, **jf)
    assert rel_err(res.params, ref.params) < 1e-10
    assert np.array_equal(res.inlier_mask.numpy(), np.asarray(ref.inlier_mask))


def test_ransac_draws():
    g = torch.Generator().manual_seed(0)
    idx = ransac.draw_subsets(g, 10, 500, 8)
    assert idx.shape == (500, 8) and idx.dtype == torch.int64
    assert all(len(set(r)) == 8 for r in idx.tolist())
    sw = torch.ones(10, dtype=torch.float64)
    sw[[2, 7]] = 0.0
    idx = ransac.draw_subsets(g, 10, 500, 5, sample_weights=sw)
    assert all(len(set(r)) == 5 for r in idx.tolist())
    assert not bool(((idx == 2) | (idx == 7)).any())


def test_ransac_matches_jax_on_a_unique_consensus():
    xs, ys, outlier = _parabola_data()
    jd = {"x": jnp.asarray(xs), "y": jnp.asarray(ys)}
    d = {"x": T(xs), "y": T(ys)}
    ref = jransac.ransac(jax.random.PRNGKey(0), jd, subset_size=3, n_hyps=256,
                         inlier_thresh_sq=0.01, **_jfns())
    res = ransac.ransac(torch.Generator().manual_seed(0), d, subset_size=3,
                        n_hyps=256, inlier_thresh_sq=0.01, **_fns())
    assert rel_err(res.params, ref.params) < 1e-10
    assert np.array_equal(res.inlier_mask.numpy(),
                          np.asarray(ref.inlier_mask))
    assert int(res.n_inliers) == int(ref.n_inliers) >= int((~outlier).sum())
    assert float((res.params - T([1.0, 2.0, 3.0])).abs().max()) < 1e-6
    ref = jransac.ransac_iterative_refit(
        jax.random.PRNGKey(1), jd, subset_size=3, n_hyps=128,
        inlier_thresh_sq=0.01, n_refine=3, **_jfns())
    res = ransac.ransac_iterative_refit(
        torch.Generator().manual_seed(1), d, subset_size=3, n_hyps=128,
        inlier_thresh_sq=0.01, n_refine=3, **_fns())
    assert rel_err(res.params, ref.params) < 1e-10
    assert np.array_equal(res.inlier_mask.numpy(),
                          np.asarray(ref.inlier_mask))


@pytest.fixture(scope="module")
def corrupted():
    """tests/test_robust_epipolar.py's scene: 80 matches, 20 corrupted."""
    s = jtwo_view(n_points=80, noise=1e-4, seed=6)
    rng = np.random.default_rng(37)
    uv1, uv2 = np.array(s.uv1), np.array(s.uv2)
    idx = rng.choice(80, 20, replace=False)
    uv2[idx] += rng.uniform(0.05, 0.3, size=(20, 2)) * rng.choice(
        [-1, 1], (20, 2))
    return uv1, uv2, idx


def test_robust_hypotheses_match_jax(corrupted):
    uv1, uv2, _ = corrupted
    sigma2 = 4e-8
    idx = ransac.draw_subsets(torch.Generator().manual_seed(2), 80, 16, 8)
    Fs, scores = robust_epipolar.hypotheses(T(uv1), T(uv2), idx,
                                            torch.tensor(sigma2),
                                            essential=True)
    for h in range(16):
        w = jnp.zeros(80).at[jnp.asarray(idx[h].numpy())].set(1.0)
        jE = jep.essential_8pt(jnp.asarray(uv1), jnp.asarray(uv2), w)
        c2 = jax.vmap(lambda a, b: jrob.sampson(jE, a, b))(
            jnp.asarray(uv1), jnp.asarray(uv2)) / sigma2
        assert rel_up_to_sign(Fs[h], jE) < 1e-8
        assert int(scores[h]) == int(jnp.sum(c2 < jrob.CHI2_2DOF_95))


def test_robust_fundamental_matches_jax(corrupted):
    uv1, uv2, idx = corrupted
    jE, jin, jc2 = jax.jit(lambda a, b: jrob.robust_fundamental(
        a, b, sigma2=4e-8, essential=True))(jnp.asarray(uv1),
                                            jnp.asarray(uv2))
    E, inl, c2 = robust_epipolar.robust_fundamental(
        T(uv1), T(uv2), sigma2=4e-8, essential=True,
        generator=torch.Generator().manual_seed(0))
    assert np.array_equal(inl.numpy(), np.asarray(jin))
    assert rel_up_to_sign(E, jE) < 1e-8
    assert rel_err(c2, jc2) < 1e-6
    inl = inl.numpy()
    clean = np.setdiff1d(np.arange(80), idx)
    assert not inl[idx].any() and inl[clean].mean() > 0.9
    from slam_tricks_tpu_torch.residuals.epipolar import sampson
    r = sampson(E, T(uv1[clean]), T(uv2[clean]))
    assert float(torch.sqrt(r.mean())) < 5e-4
    # the default generator (seeded 0 on the points' device)
    E0, inl0, _ = robust_epipolar.robust_fundamental(
        T(uv1), T(uv2), sigma2=4e-8, essential=True)
    assert np.array_equal(inl0.numpy(), inl)


def test_irls_median_on_an_even_count():
    """jnp.median averages the two middle values of an even count;
    torch.median returns the lower one. The IRLS scale must be
    jnp.median's."""
    c2 = np.random.default_rng(8).exponential(size=80)
    ref = float(jnp.median(jnp.asarray(c2)))
    assert robust_epipolar.median(T(c2)).item() == pytest.approx(ref,
                                                                 rel=1e-15)
    assert torch.median(T(c2)).item() != pytest.approx(ref, rel=1e-6)
    odd = c2[:79]
    assert robust_epipolar.median(T(odd)).item() == float(
        jnp.median(jnp.asarray(odd)))


@pytest.fixture(scope="module")
def calib_scene():
    s = jcalib_scene(n_views=8, noise=0.0, seed=5)
    return s, interop.calib_scene_from_jax(s, "cpu")


def test_zhang_closed_form_matches_jax(calib_scene):
    js, ts = calib_scene
    jintr, jskew, jposes = jax.jit(jzhang.calibrate_closed_form)(
        js.board_pts, js.image_pts)
    intr, skew, poses = zhang.calibrate_closed_form(ts.board_pts,
                                                    ts.image_pts)
    for a, b in zip(intr, jintr):
        assert abs(float(a) - float(b)) < 1e-8 * abs(float(b))
    assert abs(float(skew) - float(jskew)) < 1e-8
    assert rel_err(poses.R, jposes.R) < 1e-9
    assert rel_err(poses.t, jposes.t) < 1e-9
    assert abs(float(intr.fx) - ts.fx) / ts.fx < 1e-6
    # the parts alone
    Hs = homography.homography_dlt(ts.board_pts, ts.image_pts)
    jHs = jax.vmap(lambda uv: jhom.homography_dlt(js.board_pts, uv))(
        js.image_pts)
    assert rel_err(Hs, jHs) < 1e-10
    i2, s2 = zhang.intrinsics_from_homographies(Hs)
    ji2, js2 = jzhang.intrinsics_from_homographies(jHs)
    assert abs(float(i2.fy) - float(ji2.fy)) < 1e-8 * float(ji2.fy)
    P = zhang.extrinsics_from_homography(intr.K, Hs[2])
    jP = jzhang.extrinsics_from_homography(jintr.K, jHs[2])
    assert rel_err(P.R, jP.R) < 1e-9 and rel_err(P.t, jP.t) < 1e-9
