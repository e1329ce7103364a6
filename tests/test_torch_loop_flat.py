"""The loop-closure solve, slam_tricks_tpu_torch/solvers/loop_flat.py, and
make_loop_scene, against the JAX package's solvers/loop_flat.py and
sim/ba_scene.py, in f64, on two noisy (pix_noise=1e-3) loop scenes with
tracks of 3 and max_band=3 (the JAX functions compile in about two thirds
of the time they take at the tracks of 5 of tests/test_loop_flat.py):

- "compressed", 16 cameras and 200 landmarks: 3 Mpad = 120 > 6 pA = 48, so
  the loop-closure factor is compressed through its support by a QR;
- "direct", 40 cameras and 250 landmarks: 3 Mpad = 48 <= 6 pA = 48, the
  factor of width 3 Mpad.

The scene and the layout are built by the same numpy steps, so they are
equal. One damped step (_solve_loop) from the same blocks agrees to 1e-9,
as one banded step does (tests/test_torch_banded_flat.py), and U Uᵀ of the
loop-closure factor to 1e-12 of its largest entry (U itself is the R of a
QR, whose row signs LAPACK chooses). A 3-iteration solve_ba_loop, with no
loss on the compressed scene and with tukey(0.02) on the direct one after
one observation in 40 is moved by N(0, 0.3) (as tests/test_loop_flat.py
does), so that both factor widths go through a whole solve, has the same
iteration count and stop flag, cost to rtol 1e-7 (atol 1e-20) and the pose
tolerances of tests/test_torch_banded_flat.py: rotations 1e-9, points 1e-8,
translations 1e-10 of their largest entry. The pose
covariances at that solution agree to 1e-10 of their largest entry, at
lam=1e-3: with lam near 0 the 16-camera circle's weakly held scale makes
the covariances ~1e7 and both packages only as exact as its conditioning."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.residuals import robust as jrobust
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.sim.ba_scene import make_loop_scene as jmake_loop
from slam_tricks_tpu.solvers import loop_flat as jlf
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.sim import make_loop_scene
from slam_tricks_tpu_torch.solvers import loop_flat
import tests.torch_util  # noqa: F401  (caps torch's threads)

SCENES = {   # make_loop_scene arguments; max_band 3
    "compressed": dict(n_cams=16, n_points=200, track_len=3, seed=31),
    "direct": dict(n_cams=40, n_points=250, track_len=3, seed=41),
}
MAX_BAND = 3


def _problem(name, outliers=False):
    """(JAX scene, JAX (poses0, points0, fixed, LoopWork), port (poses0,
    points0, fixed, LoopWork)); the port's layout is built by its own
    build_loop_work from the same observations."""
    kw = SCENES[name]
    jsc = jmake_loop(dtype=np.float64, pix_noise=1e-3, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=kw["seed"] + 1)
    obs = jsc.obs
    if outliers:
        rng = np.random.default_rng(5)
        uv = np.array(obs.uv)
        live = np.flatnonzero(np.asarray(obs.weight) > 0)
        hit = rng.choice(live, live.size // 40, replace=False)
        uv[hit] += rng.normal(scale=0.3, size=(hit.size, 2))
        obs = obs._replace(uv=jnp.asarray(uv))
    jlw = jlf.build_loop_work(obs, jsc.n_cams, jsc.n_points, dtype=np.float64,
                              max_band=MAX_BAND)
    lw = loop_flat.build_loop_work(interop.obs_from_jax(obs, "cpu"),
                                   jsc.n_cams, jsc.n_points,
                                   dtype=torch.float64, max_band=MAX_BAND)
    port = (interop.poses_from_jax(jp0, "cpu"), interop.tensor(jx0, "cpu"),
            interop.tensor(jfx, "cpu"), lw)
    return jsc, (jp0, jx0, jfx, jlw), port


@pytest.mark.parametrize("dtype, extra", [
    (np.float64, dict(n_cams=48, n_points=800, track_len=5, seed=31)),
    (np.float32, dict(n_cams=40, n_points=250, track_len=4, seed=41,
                      loop_frac=0.01, pix_noise=1e-3))])
def test_make_loop_scene_bit_identical(dtype, extra):
    jsc = jmake_loop(dtype=dtype, **extra)
    sc = make_loop_scene(dtype=torch.float64 if dtype == np.float64
                         else torch.float32, device="cpu", **extra)
    assert (sc.n_cams, sc.n_points) == (jsc.n_cams, jsc.n_points)
    for a, b in zip(sc.obs, jsc.obs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((sc.poses_true.R, jsc.poses_true.R),
                 (sc.poses_true.t, jsc.poses_true.t),
                 (sc.points_true, jsc.points_true)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_make_loop_scene_needs_two_windows():
    for make in (jmake_loop, make_loop_scene):
        with pytest.raises(ValueError, match="2\\*track_len"):
            make(n_cams=9, n_points=50, track_len=5)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_loop_work_matches_jax(name):
    jsc, (*_, jlw), (*_, lw) = _problem(name)
    conv = interop.loop_work_from_jax(jlw, jsc.n_points, "cpu")
    uv = np.asarray(jlw.lc_uv)
    for work in (lw, conv):
        np.testing.assert_array_equal(work.lc_uv0.numpy(), uv[:, 0])
        np.testing.assert_array_equal(work.lc_uv1.numpy(), uv[:, 1])
        for mine, theirs in (("lc_w", "lc_weight"), ("lc_aslot", "lc_aslot"),
                             ("lc_lm", "lc_lm"), ("lc_gather", "lc_gather"),
                             ("onehot_A", "onehot_A")):
            np.testing.assert_array_equal(getattr(work, mine).numpy(),
                                          np.asarray(getattr(jlw, theirs)))
        b, jb = work.banded, jlw.banded
        np.testing.assert_array_equal(b.w.numpy(), np.asarray(jb.weight))
        np.testing.assert_array_equal(b.scatter_idx.numpy(),
                                      np.asarray(jb.scatter_idx))
        np.testing.assert_array_equal(b.c0.numpy(),
                                      np.argmax(np.asarray(jb.onehot), 1))
    q = min(3 * lw.lc_w.shape[1], 6 * lw.onehot_A.shape[0])
    compressed = 3 * lw.lc_w.shape[1] > 6 * lw.onehot_A.shape[0]
    assert compressed == (name == "compressed"), q


def _jax_step(p, x, lw, fx, C):
    """One damped JAX step from the initial blocks, and the Gram U Uᵀ of its
    loop-closure factor."""
    b = jlf._banded_quantities(p, x[lw.banded.gather_idx], lw.banded, C)
    cam_lc, Hll_lc, gl_lc, W_lc = jlf._lc_quantities(p, x[lw.lc_gather], lw,
                                                     C)
    lam = jnp.asarray(1e-4, x.dtype)
    out = jlf._solve_loop(b[0] + cam_lc[:, :21], b[1] + cam_lc[:, 21:27],
                          list(b[2]), b[3], b[4], list(Hll_lc), gl_lc, W_lc,
                          lam, fx, lw, C)
    Hd, _ = jlf._damp_hll(list(Hll_lc), lam)
    free = (~fx).astype(x.dtype)
    Ua = jlf._lc_factor(W_lc, Hd, lw, lw.onehot_A @ free, x.dtype)
    Uf = Ua.reshape(-1, Ua.shape[-1])
    return out, Uf @ Uf.T


@pytest.mark.parametrize("name", sorted(SCENES))
def test_solve_loop_step_matches_jax(name):
    jsc, (jp0, jx0, jfx, jlw), (p0, x0, fx, lw) = _problem(name)
    ref, ref_gram = jax.jit(functools.partial(_jax_step, C=jsc.n_cams))(
        jp0, jx0, jlw, jfx)
    bw = lw.banded
    (Hpp, gp, Hll, gl, W), _ = loop_flat._banded_quantities(
        p0, x0[bw.gather_idx], bw)
    cam_lc, Hll_lc, gl_lc, W_lc = loop_flat._lc_quantities(
        p0, x0[lw.lc_gather], lw)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    out = loop_flat._solve_loop(Hpp + cam_lc[:, :21], gp + cam_lc[:, 21:27],
                                Hll, gl, W, Hll_lc, gl_lc, W_lc, lam, fx, lw)
    labels = ("dp", "dl_sr", "dl_lc", "diag_pp", "diag_sr", "diag_lc")
    for label, a, b in zip(labels, out, ref):
        assert tuple(a.shape) == tuple(b.shape), label
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9, err_msg=label)
    Hd, _ = loop_flat.damp_hll(Hll_lc, lam)
    Ua = loop_flat._lc_factor(W_lc, Hd, lw, lw.onehot_A @ (~fx).double())
    Uf = Ua.reshape(-1, Ua.shape[-1])
    gram = np.asarray(ref_gram)
    np.testing.assert_allclose((Uf @ Uf.T).numpy(), gram, rtol=0,
                               atol=1e-12 * np.abs(gram).max())


@pytest.fixture(scope="module")
def solves():
    """The JAX and port 3-iteration solves: no loss on the noisy compressed
    scene, tukey(0.02) on the direct one with outliers."""
    out = {}
    for label, name, outliers, jl, tl in (
            ("none", "compressed", False, None, None),
            ("tukey", "direct", True, jrobust.tukey(0.02),
             robust.tukey(0.02))):
        _, (jp0, jx0, jfx, jlw), (p0, x0, fx, lw) = _problem(name, outliers)
        ref = jlf.solve_ba_loop(jp0, jx0, jlw, fixed_mask=jfx, max_iters=3,
                                loss=jl)
        got = loop_flat.solve_ba_loop(p0, x0, lw, fixed_mask=fx, max_iters=3,
                                      loss=tl)
        out[label] = (ref, got, (jfx, jlw), (fx, lw))
    return out


@pytest.mark.parametrize("loss", ["none", "tukey"])
def test_solve_ba_loop_matches_jax(solves, loss):
    ref, out, _, _ = solves[loss]
    assert (out.it, out.done) == (int(ref.it), bool(ref.done))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-7,
                               atol=1e-20)
    np.testing.assert_allclose(out.poses.R.numpy(), np.asarray(ref.poses.R),
                               rtol=0, atol=1e-9)
    t_ref = np.asarray(ref.poses.t)
    np.testing.assert_allclose(out.poses.t.numpy(), t_ref, rtol=0,
                               atol=1e-10 * np.abs(t_ref).max())
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points),
                               rtol=0, atol=1e-8)


def test_loop_pose_covariances_match_jax(solves):
    ref, _, (jfx, jlw), (fx, lw) = solves["none"]
    want = np.asarray(jlf.loop_pose_covariances(ref.poses, ref.points, jlw,
                                                jfx, lam=1e-3))
    got = loop_flat.loop_pose_covariances(
        interop.poses_from_jax(ref.poses, "cpu"),
        interop.tensor(ref.points, "cpu"), lw, fx, lam=1e-3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
