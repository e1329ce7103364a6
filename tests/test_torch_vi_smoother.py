"""The generic LM solver of the port (slam_tricks_tpu_torch/solvers/lm.py,
the linearization and damped solve of solvers/common.py) and the dense VI
smoother and VI bundle adjustment of estimation/vi_smoother.py against the
JAX package's, on the same numpy inputs, in f64:

- common.linearize (torch.func.jacfwd) against the JAX package's
  (jax.jacfwd) on the dense smoother's residual: r and J to 1e-12
  relative;
- common.solve_damped_normal at n = 6 (the unrolled small Cholesky) and
  n = 30 (ops.spd_solve), with and without Marquardt scaling: 1e-12; a
  system that is not positive definite gives a zero step and bad, as in
  the JAX package;
- levenberg_marquardt on a small weighted fit of a pose and a focal
  scale (SO(3) x R^3 x R, 24 residuals): at 3 iterations the same count,
  cost rtol 1e-10, x to 1e-10; with a cap of 50 the cost to rtol 1e-10
  and x to 1e-9 (the focal scale and the depth nearly trade off, so the
  optimum is flat along one direction, where the JAX package's steps at
  the floor moved t by 1.2e-10). The stop is not compared there: the port's
  gradient fell below gtol after 6 steps, where the JAX package's
  rejected steps ran to the cap (its gradient 3e-11); the callback sees
  every step;
- solve_vi_smoother on the JAX package's chain-parity problem (K = 20):
  at 4 iterations the same count, cost rtol 1e-10 and poses 1e-10; at 40,
  cost rtol 1e-10, poses and bias 1e-10 (both stop on a short step, at
  different iterations of the floor);
- the port's chain and dense solvers on that problem, from the port's own
  simulation: cost rtol 1e-10, positions and bias 1e-10 (the JAX
  package's own parity test, tests/test_preintegration.py:294);
- solve_vi_ba on test_vi_ba_recovers_metric_scale's problem with 60
  landmarks (K = 12, 100 samples a segment, a 0.7x-scaled start): cost
  rtol 1e-10, poses 1e-9 and the recovered scale within 0.03 of 1;
- solve_vi_smoother in float32 beats the observations.

Each JAX reference solve runs once a module under jax.jit and is waited
for before the port runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.estimation import vi_smoother as jvis
from slam_tricks_tpu.manifolds import manifold as jman
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu.manifolds import so3 as jso3
from slam_tricks_tpu.solvers import common as jcommon
from slam_tricks_tpu.solvers.lm import levenberg_marquardt as jlm
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.estimation import vi_chain as vc
from slam_tricks_tpu_torch.estimation import vi_smoother as vis
from slam_tricks_tpu_torch.evaluation import metrics
from slam_tricks_tpu_torch.manifolds import manifold as man
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.solvers import common
from slam_tricks_tpu_torch.solvers.lm import levenberg_marquardt
from tests.torch_util import rel_err

_SIG = dict(obs_rot_sigma=0.005, obs_trans_sigma=0.01)
_SIM = dict(n_keyframes=20, samples_per_seg=50, dt=0.005, sigma_g=2e-4,
            sigma_a=2e-3, obs_rot_noise=0.005, obs_trans_noise=0.01, seed=3)


@pytest.fixture(scope="module")
def k20():
    sim = jvis.simulate_vi(**_SIM)
    b0 = jnp.zeros(6)
    pre = jvis.preintegrate_segments(sim, b0[:3], b0[3:], sigma_g=2e-4,
                                     sigma_a=2e-3)
    solve = jax.jit(lambda mi: jvis.solve_vi_smoother(
        pre, sim.obs_poses, sim.obs_poses, sim.vels_true, b0, max_iters=mi,
        **_SIG))
    sols = {n: jax.block_until_ready(solve(n)) for n in (4, 40)}
    return (sim, pre, interop.vi_sim_from_jax(sim, device="cpu"),
            interop.preintegrated_from_jax(pre, device="cpu"), sols)


def _fit_problem():
    """A camera pose and a focal scale from 12 known points seen as noisy
    normalized-plane projections (24 residuals, 7 unknowns on
    SO(3) x R^3 x R), the same numbers for both packages."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(12, 3)) + np.array([0.0, 0.0, 5.0])
    R_true = np.asarray(jso3.exp(jnp.asarray([0.1, -0.05, 0.2])))
    t_true = np.array([0.2, -0.1, 0.3])
    pc = (X - t_true) @ R_true
    uv = 1.1 * pc[:, :2] / pc[:, 2:] + rng.normal(0, 1e-3, (12, 2))
    w = rng.uniform(0.5, 2.0, 24)
    R0 = np.asarray(jso3.exp(jnp.asarray([0.15, 0.0, 0.1])))
    t0 = t_true + np.array([0.05, 0.05, -0.1])
    return uv, w, (R0, t0, np.array([1.0])), X


def _fit_residual(lib, uv, X):
    def residual(x):
        pose, f = x
        pc = (X - pose.t) @ pose.R
        return (f * pc[:, :2] / pc[:, 2:] - uv).reshape(-1)
    return residual


@pytest.fixture(scope="module")
def fit():
    uv, wts, (R0, t0, f0), X = _fit_problem()
    mani = jman.product(jman.so3_r3(), jman.euclidean((1,)))
    res = _fit_residual(jnp, jnp.asarray(uv), jnp.asarray(X))
    x0 = (jse3.SE3(jnp.asarray(R0), jnp.asarray(t0)), jnp.asarray(f0))
    solve = jax.jit(lambda mi: jlm(res, x0, mani, max_iters=mi,
                                   weights=jnp.asarray(wts)))
    return ((uv, wts, (R0, t0, f0), X),
            {n: jax.block_until_ready(solve(n)) for n in (3, 50)})


@pytest.mark.parametrize("iters", [3, 50])
def test_levenberg_marquardt_matches_jax(iters, fit):
    (uv, wts, (R0, t0, f0), X), sols = fit
    sol = sols[iters]
    T_ = torch.tensor
    mani = man.product(man.so3_r3(), man.euclidean((1,)))
    res = _fit_residual(torch, T_(uv), T_(X))
    seen = []
    out = levenberg_marquardt(res, (se3.SE3(T_(R0), T_(t0)), T_(f0)), mani,
                              max_iters=iters, weights=T_(wts),
                              callback=lambda i, c, lam: seen.append(i))
    assert seen == list(range(out.iterations))
    if iters == 3:
        assert out.iterations == int(sol.iterations) == 3
        assert not out.converged and not bool(sol.converged)
        np.testing.assert_allclose(float(out.cost), float(sol.cost),
                                   rtol=1e-10)
        assert rel_err(out.grad_norm, sol.grad_norm) < 1e-9
    else:
        np.testing.assert_allclose(float(out.cost), float(sol.cost),
                                   rtol=1e-10)
    pose, f = out.x
    tol = 1e-10 if iters == 3 else 1e-9
    for a, b in ((pose.R, sol.x[0].R), (pose.t, sol.x[0].t), (f, sol.x[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("n, scaling", [(6, True), (6, False), (30, True),
                                        (30, False)])
def test_solve_damped_normal_matches_jax(n, scaling):
    rng = np.random.default_rng(n)
    J = rng.normal(size=(2 * n, n))
    H, g = J.T @ J, rng.normal(size=n)
    want, bad_j = jcommon.solve_damped_normal(jnp.asarray(H), jnp.asarray(g),
                                              1e-3, scaling)
    got, bad = common.solve_damped_normal(torch.as_tensor(H),
                                          torch.as_tensor(g),
                                          torch.tensor(1e-3,
                                                       dtype=torch.float64),
                                          scaling)
    assert not bool(bad) and not bool(bad_j)
    assert rel_err(got, want) < 1e-12
    # not positive definite: a zero step, flagged, as in the JAX package
    Hb = H.copy()
    Hb[1, 1] = -50.0 * abs(Hb[1, 1])
    got, bad = common.solve_damped_normal(torch.as_tensor(Hb),
                                          torch.as_tensor(g), 1e-3, scaling)
    want, bad_j = jcommon.solve_damped_normal(jnp.asarray(Hb), jnp.asarray(g),
                                              1e-3, scaling)
    assert bool(bad) and bool(bad_j)
    assert float(got.abs().max()) == 0.0 == float(jnp.abs(want).max())


class _Captured(Exception):
    pass


def _smoother_residuals(k20):
    """The dense smoother's residual functions of both packages, with their
    start and manifold: what each solve_vi_smoother hands its LM."""
    sim, pre, tsim, tpre, _ = k20
    got = {}
    for mod, key in ((jvis, "jax"), (vis, "torch")):
        real = mod.levenberg_marquardt

        def spy(fn, x0, mani, *a, _key=key, **kw):
            got[_key] = (fn, x0, mani)
            raise _Captured

        mod.levenberg_marquardt = spy
        try:
            with pytest.raises(_Captured):
                if key == "jax":
                    jvis.solve_vi_smoother(pre, sim.obs_poses, sim.obs_poses,
                                           sim.vels_true, jnp.zeros(6),
                                           **_SIG)
                else:
                    vis.solve_vi_smoother(tpre, tsim.obs_poses,
                                          tsim.obs_poses, tsim.vels_true,
                                          torch.zeros(6, dtype=torch.float64),
                                          **_SIG)
        finally:
            mod.levenberg_marquardt = real
    return got


def test_linearize_matches_jax(k20):
    got = _smoother_residuals(k20)
    fn_j, x_j, mani_j = got["jax"]
    fn_t, x_t, mani_t = got["torch"]
    r_j, J_j = jax.jit(lambda: jcommon.linearize(fn_j, mani_j, x_j))()
    r_t, J_t = common.linearize(fn_t, mani_t, x_t)
    assert tuple(J_t.shape) == J_j.shape == (9 * 19 + 6 * 20 + 6, 9 * 20 + 6)
    assert rel_err(r_t, r_j) < 1e-12
    assert rel_err(J_t, J_j) < 1e-12


@pytest.mark.parametrize("iters", [4, 40])
def test_solve_vi_smoother_matches_jax(iters, k20):
    sim, pre, tsim, tpre, sols = k20
    sol = sols[iters]
    out = vis.solve_vi_smoother(tpre, tsim.obs_poses, tsim.obs_poses,
                                tsim.vels_true,
                                torch.zeros(6, dtype=torch.float64),
                                max_iters=iters, **_SIG)
    if iters == 4:
        assert out.iterations == int(sol.iterations) == 4
    np.testing.assert_allclose(float(out.cost), float(sol.cost), rtol=1e-10)
    for a, b in ((out.poses.t, sol.poses.t), (out.poses.R, sol.poses.R),
                 (out.bias, sol.bias)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)


def test_chain_and_dense_agree():
    sim = vis.simulate_vi(device="cpu", **_SIM)
    b0 = torch.zeros(6, dtype=torch.float64)
    pre = vis.preintegrate_segments(sim, b0[:3], b0[3:], sigma_g=2e-4,
                                    sigma_a=2e-3)
    dense = vis.solve_vi_smoother(pre, sim.obs_poses, sim.obs_poses,
                                  sim.vels_true, b0, max_iters=40, **_SIG)
    chain = vc.solve_vi_chain(pre, sim.obs_poses, sim.obs_poses,
                              sim.vels_true, b0, max_iters=40, **_SIG)
    np.testing.assert_allclose(float(chain.cost), float(dense.cost),
                               rtol=1e-10)
    assert float((chain.poses.t - dense.poses.t).abs().max()) < 1e-10
    assert float((chain.bias - dense.bias).abs().max()) < 1e-10


def test_solve_vi_ba_matches_jax():
    sim = jvis.simulate_vi(n_keyframes=12, samples_per_seg=100, dt=0.005,
                           sigma_g=1e-4, sigma_a=1e-3, seed=11)
    pts, uv, w = jvis.simulate_vi_landmarks(sim, n_landmarks=60,
                                            uv_noise=5e-4, seed=2)
    s0, c = 0.7, sim.poses_true.t[0]
    poses0 = jse3.SE3(sim.poses_true.R, c + s0 * (sim.poses_true.t - c))
    points0, vels0, b0 = c + s0 * (pts - c), s0 * sim.vels_true, jnp.zeros(6)
    pre = jvis.preintegrate_segments(sim, b0[:3], b0[3:], sigma_g=1e-4,
                                     sigma_a=1e-3)
    prior = jax.tree_util.tree_map(lambda a: a[0], sim.poses_true)
    sol, pts_j = jax.block_until_ready(jax.jit(lambda: jvis.solve_vi_ba(
        pre, uv, w, poses0, vels0, b0, points0, pose0_prior=prior))())
    C = lambda a: interop.tensor(a, "cpu")  # noqa: E731
    out, pts_t = vis.solve_vi_ba(
        interop.preintegrated_from_jax(pre, "cpu"), C(uv), C(w),
        interop.poses_from_jax(poses0, "cpu"), C(vels0),
        torch.zeros(6, dtype=torch.float64), C(points0),
        pose0_prior=interop.poses_from_jax(prior, "cpu"))
    np.testing.assert_allclose(float(out.cost), float(sol.cost), rtol=1e-10)
    for a, b in ((out.poses.t, sol.poses.t), (out.poses.R, sol.poses.R),
                 (pts_t, pts_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    t, tt = out.poses.t.numpy(), np.asarray(sim.poses_true.t)
    scale = np.mean(np.linalg.norm(t[1:] - t[:-1], axis=1)
                    / np.linalg.norm(tt[1:] - tt[:-1], axis=1))
    assert abs(scale - 1.0) < 0.03, scale


def test_solve_vi_smoother_f32_beats_observations():
    sim = vis.simulate_vi(n_keyframes=8, samples_per_seg=20, sigma_g=2e-4,
                          sigma_a=2e-3, obs_rot_noise=0.01,
                          obs_trans_noise=0.02, seed=5, dtype=torch.float32,
                          device="cpu")
    b0 = torch.zeros(6)
    pre = vis.preintegrate_segments(sim, b0[:3], b0[3:], sigma_g=2e-4,
                                    sigma_a=2e-3)
    T0 = se3.SE3(sim.obs_poses.R[0], sim.obs_poses.t[0])
    poses_dr, vels_dr = vis.dead_reckon(pre, T0, sim.vels_true[0], b0[:3],
                                        b0[3:])
    sol = vis.solve_vi_smoother(pre, sim.obs_poses, poses_dr, vels_dr, b0)
    assert sol.poses.t.dtype == torch.float32
    ate_obs = float(metrics.ate_translation_rmse(sim.obs_poses,
                                                 sim.poses_true))
    ate = float(metrics.ate_translation_rmse(sol.poses, sim.poses_true))
    assert ate < ate_obs, (ate, ate_obs)
