"""slam_tricks_tpu_torch/solvers/sliding_window.py and evaluation/metrics.py
against the JAX package's sliding_window and metrics, in f64, on small
trajectories (tests/test_sliding_window.py's scenes, 16 to 30 cameras).

Tolerances: a window solve with a non-empty prior, its first step to 1e-9
relative and eight steps in the iteration count, the cost to rtol 1e-8 and
the state to 1e-8; each marginalization prior of a sweep (H and anchors)
to 1e-9 of each one's largest entry, xi0 to 1e-7 of its largest (a solve
with Hnew + 1e-6 I, ill-conditioned along the gauge), the consumed
landmarks equal; the whole sweep of 4 windows with pixel noise 1e-3 (the
priors' means up to 0.59) in the iteration counts, each window's cost to
rtol 1e-7, the rotations and translations to 1e-9 and the points to 1e-8
of their largest entry, and each prior's H and xi0 to 1e-8 and 1e-7 of
its largest (measured: 3.0e-9, 2.1e-11, 2.5e-11, 7.2e-10, 3.1e-10 and
5.7e-9); the metrics to 1e-12 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.evaluation import metrics as jmetrics
from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import schur_flat as jflat
from slam_tricks_tpu.solvers import sliding_window as jsw
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.evaluation import metrics
from slam_tricks_tpu_torch.sim import make_trajectory_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import schur_flat, sliding_window
from tests.torch_util import rel_err

f64 = torch.float64
PERTURB = dict(pose_rot_noise=0.002, pose_trans_noise=0.01, point_noise=0.01)


def _scene(n_cams, n_points, track_len, seed, pix_noise=1e-3):
    kw = dict(n_cams=n_cams, n_points=n_points, track_len=track_len,
              seed=seed, pix_noise=pix_noise)
    jsc = jmake_trajectory(dtype=np.float64, **kw)
    jp0, jx0, _ = jperturb_scene(jsc, seed=seed + 1, **PERTURB)
    sc = make_trajectory_scene(dtype=f64, device="cpu", **kw)
    p0, x0, _ = perturb_scene(sc, seed=seed + 1, **PERTURB)
    return (jsc, jp0, jx0), (sc, p0, x0)


def _prior(jsc, na, seed):
    """A non-empty prior on the first na cameras: random SPD information,
    a small mean offset, anchors at the true poses."""
    rng = np.random.default_rng(seed)
    P = 6 * na
    A = rng.normal(size=(P, P))
    H = 1e2 * (A @ A.T / P + np.eye(P))
    xi0 = 1e-3 * rng.normal(size=P)
    jprior = jsw.WindowPrior(H=jnp.asarray(H), xi0=jnp.asarray(xi0),
                             anchor_R=jsc.poses_true.R[:na],
                             anchor_t=jsc.poses_true.t[:na])
    return jprior, interop.window_prior_from_jax(jprior, "cpu")


@pytest.mark.parametrize("max_iters", [1, 8])
def test_solve_window_with_prior_matches_jax(max_iters):
    (jsc, jp0, jx0), (sc, p0, x0) = _scene(16, 300, 4, 91)
    C, L = sc.n_cams, sc.n_points
    jwork = jflat.build_flat_work(jsc.obs, C, L, dtype=np.float64,
                                  use_cam_table=False)
    work = schur_flat.build_flat_work(sc.obs, C, L, dtype=f64,
                                      use_cam_table=False)
    jprior, prior = _prior(jsc, 2, 5)
    # the prior's cameras are free: the last camera holds the gauge
    fx = torch.zeros(C, dtype=torch.bool)
    fx[-1] = True
    ref = jsw.solve_window(jp0, jx0, jsc.obs, jwork, jprior,
                           fixed_mask=jnp.asarray(fx.numpy()),
                           max_iters=max_iters)
    out = sliding_window.solve_window(p0, x0, sc.obs, work, prior,
                                      fixed_mask=fx, max_iters=max_iters)
    assert out.it == int(ref.it)
    if max_iters == 1:
        for a, r in ((out.poses.t, ref.poses.t), (out.points, ref.points),
                     (out.cost, ref.cost)):
            assert rel_err(a, r) < 1e-9
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-8)
    for a, r in ((out.poses.R, ref.poses.R), (out.poses.t, ref.poses.t),
                 (out.points, ref.points)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)
    jc, jg = jsw.prior_cost_grad(ref.poses, jprior)
    c, g = sliding_window.prior_cost_grad(out.poses, prior)
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-6)


SWEEP = dict(window=12, shift=6, na=3, max_iters=8)


def _recording(module, calls):
    """module.marginalize wrapped to append (args, kw, result) to calls."""
    marginalize = module.marginalize

    def record(*args, **kw):
        out = marginalize(*args, **kw)
        calls.append((args, kw, out))
        return out
    return marginalize, record


@pytest.fixture(scope="module")
def sweep():
    """One sweep of a 30-camera trajectory with pixel noise 1e-3 by both
    packages, each package's marginalize calls recorded. No window meets
    the step test (the scale that no camera fixes keeps LM stepping), so
    each stops at max_iters; 8 iterations, where more only walk the
    gauge: at 30 the two packages' windows end 2e-8 apart."""
    (jsc, jp0, jx0), (sc, p0, x0) = _scene(30, 600, 5, 97)
    jcalls, calls = [], []
    jreal, jrecord = _recording(jsw, jcalls)
    real, record = _recording(sliding_window, calls)
    jsw.marginalize, sliding_window.marginalize = jrecord, record
    try:
        jout = jsw.run_sliding_window(jsc.obs, jp0, jx0, **SWEEP)
        out = sliding_window.run_sliding_window(sc.obs, p0, x0, **SWEEP)
    finally:
        jsw.marginalize, sliding_window.marginalize = jreal, real
    return (jsc, jp0, jout), (sc, p0, out), (jcalls, calls)


def test_marginalize_prior_matches_jax(sweep):
    """Each marginalization of the sweep (the first with the fixed camera's
    1e8 diagonal, the later ones folding in a prior), from the JAX
    package's own inputs."""
    *_, (calls, _) = sweep
    assert len(calls) == 3
    for (poses, points, obs_np, prior), kw, (jnew, jused) in calls:
        kw = dict(kw)
        if kw.get("fixed_mask") is not None:
            kw["fixed_mask"] = interop.tensor(kw["fixed_mask"], "cpu")
        new, used = sliding_window.marginalize(
            interop.poses_from_jax(poses, "cpu"),
            interop.tensor(points, "cpu"), obs_np,
            interop.window_prior_from_jax(prior, "cpu"), **kw)
        np.testing.assert_array_equal(used, np.asarray(jused))
        for name, a, r in zip(sliding_window.WindowPrior._fields, new, jnew):
            r = np.asarray(r)
            assert a.shape == r.shape, name
            tol = 1e-7 if name == "xi0" else 1e-9
            np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                       atol=tol * np.abs(r).max(),
                                       err_msg=name)


def _rel_max(a, r):
    """max |a - r| / max |r|."""
    r = np.asarray(r)
    return float(np.abs(np.asarray(a) - r).max() / np.abs(r).max())


def test_run_sliding_window_matches_jax(sweep):
    (jsc, jp0, (jposes, jpoints, jdiag)), (sc, p0, (poses, points, diag)), \
        (jcalls, calls) = sweep
    assert len(diag) == len(jdiag) == 4
    for d, jd in zip(diag, jdiag):
        assert (d["w0"], d["it"], d["n_obs"]) == (jd["w0"], jd["it"],
                                                  jd["n_obs"])
        np.testing.assert_allclose(d["cost"], jd["cost"], rtol=1e-7)
    for name, a, r, tol in (("R", poses.R, jposes.R, 1e-9),
                            ("t", poses.t, jposes.t, 1e-9),
                            ("points", points, jpoints, 1e-8)):
        assert _rel_max(a, r) < tol, (name, _rel_max(a, r))
    # the priors the two sweeps formed, each from its own state
    assert len(calls) == len(jcalls) == 3
    for (*_, (new, _)), (*_, (jnew, _)) in zip(calls, jcalls):
        assert float(np.abs(np.asarray(jnew.xi0)).max()) > 0.1
        assert _rel_max(new.H, jnew.H) < 1e-8
        assert _rel_max(new.xi0, jnew.xi0) < 1e-7


def test_noiseless_sweep_improves_on_start():
    """The port's sweep of the same trajectory without pixel noise ends
    nearer the truth than its start (0.0081 against 0.0147 here)."""
    sc = make_trajectory_scene(n_cams=30, n_points=600, track_len=5, seed=97,
                               dtype=f64, device="cpu")
    p0, x0, _ = perturb_scene(sc, seed=98, **PERTURB)
    poses, _, diag = sliding_window.run_sliding_window(sc.obs, p0, x0,
                                                       **SWEEP)
    assert len(diag) == 4
    ate0 = float(metrics.ate_translation_rmse(p0, sc.poses_true))
    ate = float(metrics.ate_translation_rmse(poses, sc.poses_true))
    assert ate < ate0, (ate, ate0)


@pytest.mark.parametrize("window, shift, na", [(12, 0, 3), (12, 6, 8),
                                               (12, 2, 3)])
def test_run_sliding_window_argument_errors(window, shift, na):
    """shift outside (0, window]; na > window - shift; shift < na."""
    sc = make_trajectory_scene(n_cams=24, n_points=100, track_len=3, seed=5,
                               dtype=f64, device="cpu")
    with pytest.raises(ValueError):
        sliding_window.run_sliding_window(
            sc.obs, sc.poses_true, sc.points_true, window=window, shift=shift,
            na=na)


def test_metrics_match_jax():
    (jsc, jp0, jx0), (sc, p0, x0) = _scene(24, 300, 4, 99)
    jT, T = jsc.poses_true, sc.poses_true
    o, jo = sc.obs, jsc.obs
    e = torch.as_tensor(np.random.default_rng(2).normal(size=(40, 3)))
    for a, r in zip(metrics.stats(e), jmetrics.stats(jnp.asarray(e.numpy()))):
        assert rel_err(a, r) < 1e-12
    assert rel_err(metrics.ate_rmse(p0, T), jmetrics.ate_rmse(jp0, jT)) < 1e-12
    assert rel_err(metrics.ate_translation_rmse(p0, T),
                   jmetrics.ate_translation_rmse(jp0, jT)) < 1e-12
    # a similarity of the truth aligns back onto it
    al = metrics.align_trajectories(p0, T)
    jal = jmetrics.align_trajectories(jp0, jT)
    assert rel_err(al.R, jal.R) < 1e-12 and rel_err(al.t, jal.t) < 1e-12
    assert rel_err(
        metrics.reprojection_rms(p0, x0, o.cam_idx, o.lm_idx, o.uv, o.weight),
        jmetrics.reprojection_rms(jp0, jx0, jo.cam_idx, jo.lm_idx, jo.uv,
                                  jo.weight)) < 1e-12
