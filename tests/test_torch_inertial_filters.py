"""The visual-inertial initializer, the SE(3) error-state Kalman filter and
the strapdown INS of the port (slam_tricks_tpu_torch/estimation/vi_init.py,
eskf.py, ins.py) against the JAX package's, on the same numpy inputs, in
f64:

- vi_initialize's linear system to 1e-15 (absolute; entries O(1)), and its
  scale, gravity and velocities on the JAX package's two problems (clean
  IMU at 2.3x scale, tests/test_preintegration.py:240; true biases left in
  and noise, :259): the same solution to 1e-9 relative (both are
  least-squares solves, JAX's by SVD, the port's by QR), with the JAX
  tests' own gates (scale within 1e-4 of 2.3, |g| = 9.81);
- predict, update_pose and filter_trajectory over the JAX package's
  80-step spiral (tests/test_estimation.py:25), every step observed and
  every third skipped: poses and covariance to 1e-12, the filter's ATE
  below half the observations' (the JAX test's gate); through
  interop.eskf_state_from_jax;
- radii, normal_gravity and mechanize_trajectory: the JAX test's 6000
  steps of a stationary IMU (tests/test_estimation.py:78, its drift
  gates) and 300 steps of a moving one, the histories to 1e-9 relative
  (lat, lon in radians: 1e-12 absolute); through
  interop.ins_state_from_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.estimation import eskf as jeskf
from slam_tricks_tpu.estimation import ins as jins
from slam_tricks_tpu.estimation import vi_init as jvi
from slam_tricks_tpu.estimation import vi_smoother as jvis
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu.sim.trajectory import spiral_poses
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.estimation import eskf, ins, vi_init
from slam_tricks_tpu_torch.evaluation import metrics
from slam_tricks_tpu_torch.manifolds import se3
from tests.torch_util import rel_err


def _init_problem(kind):
    if kind == "clean":
        sim = jvis.simulate_vi(n_keyframes=12, samples_per_seg=50, dt=0.005,
                               bg=(0, 0, 0), ba=(0, 0, 0))
    else:
        sim = jvis.simulate_vi(n_keyframes=16, samples_per_seg=100, dt=0.005,
                               sigma_g=2e-4, sigma_a=2e-3, seed=4)
    z3 = jnp.zeros(3)
    pre = jvis.preintegrate_segments(sim, z3, z3)
    pv = jse3.SE3(sim.poses_true.R, sim.poses_true.t / 2.3)
    return sim, pre, pv


@pytest.mark.parametrize("kind", ["clean", "biased"])
def test_vi_initialize_matches_jax(kind):
    sim, pre, pv = _init_problem(kind)
    tpre = interop.preintegrated_from_jax(pre, device="cpu")
    tpv = interop.poses_from_jax(pv, device="cpu")
    A_j, b_j = jvi._build_system(pre, pv)
    A, b = vi_init._build_system(tpre, tpv)
    assert tuple(A.shape) == A_j.shape
    assert float((A - torch.as_tensor(np.array(A_j))).abs().max()) < 1e-15
    assert float((b - torch.as_tensor(np.array(b_j))).abs().max()) < 1e-15
    want = jax.jit(lambda: jvi.vi_initialize(pre, pv))()
    got = vi_init.vi_initialize(tpre, tpv)
    for name in ("scale", "gravity", "vels"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-9, name
    assert float(got.residual) < 2.0 * float(want.residual) + 1e-12
    g = got.gravity.numpy()
    assert abs(np.linalg.norm(g) - 9.81) < 1e-6
    if kind == "clean":
        assert abs(float(got.scale) - 2.3) < 1e-4
        np.testing.assert_allclose(g, [0, 0, -9.81], atol=1e-8)
        assert float((got.vels - interop.tensor(sim.vels_true, "cpu"))
                     .abs().max()) < 1e-4
    else:
        assert abs(float(got.scale) - 2.3) / 2.3 < 0.05 and g[2] < -9.7


def test_vi_initialize_needs_four_keyframes():
    sim, pre, pv = _init_problem("clean")
    tpre = interop.preintegrated_from_jax(pre, device="cpu")
    tpv = interop.poses_from_jax(pv, device="cpu")
    three = se3.SE3(tpv.R[:3], tpv.t[:3])
    with pytest.raises(ValueError):
        vi_init.vi_initialize(type(tpre)(*(f[:2] for f in tpre)), three)


@pytest.fixture(scope="module")
def eskf_problem():
    """The JAX test's spiral: noisy odometry and observations, numpy draws."""
    rng = np.random.default_rng(13)
    n = 80
    truth = spiral_poses(n)
    odo_sig, obs_sig = 0.002, 0.05

    def noisy(T, sig):
        return jse3.mul(T, jse3.exp(jnp.asarray(rng.normal(size=6) * sig)))

    odos, obss = [], []
    for k in range(n - 1):
        Ti = jax.tree_util.tree_map(lambda a: a[k], truth)
        Tj = jax.tree_util.tree_map(lambda a: a[k + 1], truth)
        odos.append(noisy(jse3.mul(jse3.inv(Ti), Tj), odo_sig))
        obss.append(noisy(Tj, obs_sig))
    stack = lambda xs: jax.tree_util.tree_map(  # noqa: E731
        lambda *x: jnp.stack(x), *xs)
    return (truth, stack(odos), stack(obss), jnp.eye(6) * odo_sig ** 2,
            jnp.eye(6) * obs_sig ** 2)


@pytest.mark.parametrize("mask", ["all", "every third skipped"])
def test_filter_trajectory_matches_jax(mask, eskf_problem):
    truth, odo, obs, Q, R = eskf_problem
    n = odo.t.shape[0]
    m = np.ones(n, bool) if mask == "all" else (np.arange(n) % 3 != 0)
    T0 = jax.tree_util.tree_map(lambda a: a[0], truth)
    P0 = jnp.eye(6) * 1e-6
    Ts_j, fin_j = jax.jit(lambda: jeskf.filter_trajectory(
        T0, P0, odo, obs, jnp.asarray(m), Q, R))()
    C = lambda a: interop.tensor(a, "cpu")  # noqa: E731
    st0 = interop.eskf_state_from_jax(jeskf.ESKFState(T0, P0), "cpu")
    Ts, fin = eskf.filter_trajectory(
        st0.T, st0.P, interop.poses_from_jax(odo, "cpu"),
        interop.poses_from_jax(obs, "cpu"), torch.as_tensor(m), C(Q), C(R))
    assert rel_err(Ts.R, Ts_j.R) < 1e-12 and rel_err(Ts.t, Ts_j.t) < 1e-12
    assert rel_err(fin.P, fin_j.P) < 1e-12
    tail = se3.SE3(C(truth.R[1:]), C(truth.t[1:]))
    ate = float(metrics.ate_rmse(Ts, tail))
    ate_obs = float(metrics.ate_rmse(interop.poses_from_jax(obs, "cpu"), tail))
    if mask == "all":
        assert ate < 0.5 * ate_obs, (ate, ate_obs)
    assert bool((torch.linalg.eigvalsh(fin.P) > 0).all())


def test_predict_and_update_match_jax():
    rng = np.random.default_rng(3)
    state_j = jeskf.ESKFState(jse3.identity(jnp.float64), jnp.eye(6) * 1e-4)
    state = interop.eskf_state_from_jax(state_j, "cpu")
    for _ in range(20):
        Z = jse3.exp(jnp.asarray(rng.normal(size=6) * 0.1))
        T_obs = jse3.exp(jnp.asarray(rng.normal(size=6) * 0.1))
        state_j = jeskf.update_pose(jeskf.predict(state_j, Z,
                                                  jnp.eye(6) * 1e-4),
                                    T_obs, jnp.eye(6) * 1e-2)
        eye = torch.eye(6, dtype=torch.float64)
        state = eskf.update_pose(
            eskf.predict(state, interop.poses_from_jax(Z, "cpu"), eye * 1e-4),
            interop.poses_from_jax(T_obs, "cpu"), eye * 1e-2)
    assert rel_err(state.T.R, state_j.T.R) < 1e-12
    assert rel_err(state.T.t, state_j.T.t) < 1e-12
    assert rel_err(state.P, state_j.P) < 1e-12


def test_gravity_model_matches_jax():
    lat = np.linspace(-1.5, 1.5, 7)
    h = np.linspace(-100.0, 5000.0, 7)
    for a, b in ((ins.normal_gravity(torch.as_tensor(lat), torch.as_tensor(h)),
                  jins.normal_gravity(jnp.asarray(lat), jnp.asarray(h))),
                 *zip(ins.radii(torch.as_tensor(lat)),
                      jins.radii(jnp.asarray(lat)))):
        assert rel_err(a, b) < 1e-14
    g_eq = float(ins.normal_gravity(torch.tensor(0.0, dtype=torch.float64),
                                    torch.tensor(0.0, dtype=torch.float64)))
    assert abs(g_eq - 9.78033) < 1e-4


def _ins_inputs(kind):
    lat, dt = np.deg2rad(30.0), 0.01
    ell = jins.ELLIPSOIDS["WGS84"]
    g = float(jins.normal_gravity(jnp.asarray(lat), jnp.asarray(0.0)))
    if kind == "stationary":
        n = 6000
        om = ell["omega"]
        w_ie_n = np.array([om * np.cos(lat), 0.0, -om * np.sin(lat)])
        dth = np.tile(w_ie_n * dt, (n, 1))
        dv = np.tile(np.array([0.0, 0.0, -g]) * dt, (n, 1))
        v0 = np.zeros(3)
    else:
        n = 300
        rng = np.random.default_rng(8)
        dth = rng.normal(0, 2e-3, (n, 3))
        dv = np.array([0.0, 0.0, -g]) * dt + rng.normal(0, 2e-3, (n, 3))
        v0 = np.array([10.0, -3.0, 0.5])
    state0 = jins.INSState(lat=jnp.asarray(lat), lon=jnp.asarray(0.2),
                           h=jnp.asarray(12.0), v_ned=jnp.asarray(v0),
                           q_nb=jnp.asarray([1.0, 0, 0, 0]))
    return state0, dth, dv, dt


@pytest.mark.parametrize("kind", ["stationary", "moving"])
def test_mechanize_trajectory_matches_jax(kind):
    state0, dth, dv, dt = _ins_inputs(kind)
    want = jax.jit(lambda: jins.mechanize_trajectory(
        state0, jnp.asarray(dth), jnp.asarray(dv), dt))()
    got = ins.mechanize_trajectory(interop.ins_state_from_jax(state0, "cpu"),
                                   torch.as_tensor(dth), torch.as_tensor(dv),
                                   dt)
    for name in ("lat", "lon"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(a.shape) == b.shape
        assert float((a - torch.tensor(b)).abs().max()) < 1e-12, name
    for name in ("h", "v_ned", "q_nb"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-9, name
    if kind == "stationary":      # the JAX test's drift gates
        assert abs(float(got.lat[-1]) - float(state0.lat)) * 6.37e6 < 5.0
        assert float((got.h[-1] - 12.0).abs()) < 5.0
        assert float(torch.linalg.vector_norm(got.v_ned[-1])) < 0.2
