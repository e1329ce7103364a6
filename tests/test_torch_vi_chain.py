"""The chain VI smoother of the port (slam_tricks_tpu_torch/estimation/
vi_chain.py) and its multi-right-hand-side block-tridiagonal solve against
the JAX package's, on the same numpy inputs, in f64:

- banded_flat.block_tridiag_solve (ops.tridiag_solve's plain version on
  the CPU) against JAX's block_tridiag_solve_cr at (G, m, q) = (13, 9, 7)
  and (8, 9, 1), and with a 2-D r: 1e-12 relative;
- the linearization (D, E, U, Hbb, g, gb) of _make_system, the port's
  analytic Jacobians against the JAX package's vmap(jacfwd), to 1e-10
  relative: at the solver's start (noisy observations, zero bias), at the
  JAX solve's optimum, and at the truth of a noiseless stream, where every
  rotation residual is the identity to rounding and so3.log takes its
  small-angle branch;
- solve_vi_chain on the JAX package's parity problem (K = 20, 50 samples a
  segment, tests/test_preintegration.py:294): cost rtol 1e-10, poses and
  bias to 1e-10 (velocities 1e-9), as that test holds the chain against
  the dense solver; at 4 iterations with the same count, and at the cap of
  40, where both stop on a short step. At the f64 floor the cost moves by
  ulps and the two take their last accepted steps at different
  iterations (the JAX solve under jit stopped after 9, the port after 13,
  the JAX solve without jit after 14), so there the states are compared,
  not the counts;
- vi_chain_covariances at K = 8 to 1e-8 relative, and against the dense
  bordered Hessian's inverse (the JAX package's own check, atol 1e-12);
- a float32 solve at K = 24 beats the observations (ATE), as the JAX
  package's f32 tests require.

Each JAX reference solve runs once a module under jax.jit and is waited
for before the port runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.estimation import vi_chain as jvc
from slam_tricks_tpu.estimation import vi_smoother as jvis
from slam_tricks_tpu.solvers.banded_flat import block_tridiag_solve_cr
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.estimation import vi_chain as vc
from slam_tricks_tpu_torch.estimation import vi_smoother as vis
from slam_tricks_tpu_torch.evaluation import metrics
from slam_tricks_tpu_torch.solvers import banded_flat
from tests.torch_util import rel_err

_SIG = dict(obs_rot_sigma=0.005, obs_trans_sigma=0.01)
_SIM = dict(dt=0.005, sigma_g=2e-4, sigma_a=2e-3, obs_rot_noise=0.005,
            obs_trans_noise=0.01, seed=3)


def _problem(K, S):
    """(JAX sim, JAX pre, port sim, port pre), integrated at zero bias."""
    sim = jvis.simulate_vi(n_keyframes=K, samples_per_seg=S, **_SIM)
    b0 = jnp.zeros(6)
    pre = jvis.preintegrate_segments(sim, b0[:3], b0[3:], sigma_g=2e-4,
                                     sigma_a=2e-3)
    return (sim, pre, interop.vi_sim_from_jax(sim, device="cpu"),
            interop.preintegrated_from_jax(pre, device="cpu"))


@pytest.fixture(scope="module")
def k20():
    sim, pre, tsim, tpre = _problem(20, 50)
    solve = jax.jit(lambda mi: jvc.solve_vi_chain(
        pre, sim.obs_poses, sim.obs_poses, sim.vels_true, jnp.zeros(6),
        max_iters=mi, **_SIG))
    sols = {n: jax.block_until_ready(solve(n)) for n in (4, 40)}
    return sim, pre, tsim, tpre, sols


@pytest.mark.parametrize("G, m, q", [(13, 9, 7), (8, 9, 1), (8, 9, 0)])
def test_block_tridiag_solve_matches_jax(G, m, q):
    rng = np.random.default_rng(G + q)
    A = rng.normal(size=(G, m, m + 3))
    D = A @ A.transpose(0, 2, 1) + m * np.eye(m)
    E = 0.3 * rng.normal(size=(G - 1, m, m))
    r = rng.normal(size=(G, m, q) if q else (G, m))
    want = np.asarray(block_tridiag_solve_cr(D, E, r))
    got = banded_flat.block_tridiag_solve(*(torch.as_tensor(a)
                                            for a in (D, E, r)))
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) < 1e-12


def _systems(pre, tpre, obs, tobs, K):
    anchor = jnp.concatenate([pre.bg0[0], pre.ba0[0]])
    lin_j, _ = jvc._make_system(pre, obs, jnp.float64(1 / 0.005),
                                jnp.float64(1 / 0.01), jnp.float64(1.0),
                                anchor, (0.0, 0.0, -9.81), K, jnp.float64)
    lin_t, _ = vc._system(tpre, tobs, 0.005, 0.01, 1.0, (0.0, 0.0, -9.81),
                          "test")
    return jax.jit(lin_j), lin_t


def _systems_cost(tpre, tobs):
    return vc._system(tpre, tobs, 0.005, 0.01, 1.0, (0.0, 0.0, -9.81),
                      "test")[1]


@pytest.mark.parametrize("state", ["start", "optimum", "noiseless truth"])
def test_linearization_matches_jax(state, k20):
    sim, pre, tsim, tpre, sol = k20
    K = 20
    if state == "noiseless truth":
        sim = jvis.simulate_vi(n_keyframes=K, samples_per_seg=50, dt=0.005,
                               obs_rot_noise=0.0, obs_trans_noise=0.0)
        pre = jvis.preintegrate_segments(sim, sim.bg_true, sim.ba_true)
        tsim = interop.vi_sim_from_jax(sim, device="cpu")
        tpre = interop.preintegrated_from_jax(pre, device="cpu")
        x = (sim.poses_true, sim.vels_true,
             jnp.concatenate([sim.bg_true, sim.ba_true]))
    elif state == "start":
        x = (sim.obs_poses, sim.vels_true,
             jnp.asarray([0.01, -0.02, 0.005, 0.05, 0.02, -0.03]))
    else:
        x = (sol[40].poses, sol[40].vels, sol[40].bias)
    lin_j, lin_t = _systems(pre, tpre, sim.obs_poses, tsim.obs_poses, K)
    want = jax.block_until_ready(lin_j(*x))
    xt = (interop.poses_from_jax(x[0], "cpu"), interop.tensor(x[1], "cpu"),
          interop.tensor(x[2], "cpu"))
    got = lin_t(*xt)
    # a gradient at an optimum is a sum that cancels: hold it to its
    # Cauchy-Schwarz bound sqrt(max diag H) ||r|| there, not to itself
    norm_r = np.sqrt(2.0 * float(_systems_cost(tpre, tsim.obs_poses)(*xt)))
    for name, a, b in zip(("D", "E", "U", "Hbb", "g", "gb"), got, want):
        assert tuple(a.shape) == b.shape, name
        err = rel_err(a, b)
        if name in ("g", "gb") and state != "start":
            H = got[0] if name == "g" else got[3]
            scale = np.sqrt(float(torch.diagonal(H, dim1=-2, dim2=-1).max()))
            err = float((a - torch.as_tensor(np.asarray(b))).abs().max()
                        / (scale * norm_r))
        assert err < 1e-10, (name, err)


@pytest.mark.parametrize("iters", [4, 40])
def test_solve_vi_chain_matches_jax(iters, k20):
    sim, pre, tsim, tpre, sols = k20
    sol = sols[iters]
    costs = []
    out = vc.solve_vi_chain(tpre, tsim.obs_poses, tsim.obs_poses,
                            tsim.vels_true, torch.zeros(6, dtype=torch.float64),
                            max_iters=iters, costs=costs, **_SIG)
    assert len(costs) == out.it + 1 and float(costs[-1]) == float(out.cost)
    if iters == 4:      # before the floor: the same steps
        assert out.it == int(sol.it) == 4 and not out.done
    else:
        assert out.done and bool(sol.done)
    np.testing.assert_allclose(float(out.cost), float(sol.cost), rtol=1e-10)
    np.testing.assert_allclose(out.poses.t.numpy(), np.asarray(sol.poses.t),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(out.poses.R.numpy(), np.asarray(sol.poses.R),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(out.bias.numpy(), np.asarray(sol.bias), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(out.vels.numpy(), np.asarray(sol.vels), rtol=0,
                               atol=1e-9)


@pytest.fixture(scope="module")
def k8():
    sim, pre, tsim, tpre = _problem(8, 30)
    sol = jax.block_until_ready(jax.jit(lambda: jvc.solve_vi_chain(
        pre, sim.obs_poses, sim.obs_poses, sim.vels_true, jnp.zeros(6),
        max_iters=30, **_SIG))())
    cov = jax.block_until_ready(jax.jit(lambda: jvc.vi_chain_covariances(
        pre, sim.obs_poses, sol.poses, sol.vels, sol.bias, **_SIG))())
    port = vc.vi_chain_covariances(
        tpre, tsim.obs_poses, interop.poses_from_jax(sol.poses, "cpu"),
        interop.tensor(sol.vels, "cpu"), interop.tensor(sol.bias, "cpu"),
        **_SIG)
    return sim, pre, tsim, tpre, sol, cov, port


def test_vi_chain_covariances_match_jax(k8):
    *_, (sc_j, bc_j), (sc, bc) = k8
    assert sc.shape == (8, 9, 9) and bc.shape == (6, 6)
    assert rel_err(sc, sc_j) < 1e-8
    assert rel_err(bc, bc_j) < 1e-8


def test_vi_chain_covariances_match_dense_inverse(k8):
    sim, pre, tsim, tpre, sol, _, (sc, bc) = k8
    K = 8
    lin = vc._system(tpre, tsim.obs_poses, 0.005, 0.01, 1.0,
                     (0.0, 0.0, -9.81), "test")[0]
    D, E, U, Hbb, _, _ = (a.numpy() for a in lin(
        interop.poses_from_jax(sol.poses, "cpu"),
        interop.tensor(sol.vels, "cpu"), interop.tensor(sol.bias, "cpu")))
    n = 9 * K
    H = np.zeros((n + 6, n + 6))
    for k in range(K):
        H[9 * k:9 * k + 9, 9 * k:9 * k + 9] = D[k]
        H[9 * k:9 * k + 9, n:] = U[k]
        H[n:, 9 * k:9 * k + 9] = U[k].T
    for k in range(K - 1):
        H[9 * (k + 1):9 * (k + 2), 9 * k:9 * k + 9] = E[k]
        H[9 * k:9 * k + 9, 9 * (k + 1):9 * (k + 2)] = E[k].T
    H[n:, n:] = Hbb
    Hinv = np.linalg.inv(H)
    for k in range(K):
        np.testing.assert_allclose(sc[k].numpy(),
                                   Hinv[9 * k:9 * k + 9, 9 * k:9 * k + 9],
                                   atol=1e-12)
    np.testing.assert_allclose(bc.numpy(), Hinv[n:, n:], atol=1e-12)


def test_solve_vi_chain_f32_beats_observations():
    sim = vis.simulate_vi(n_keyframes=24, samples_per_seg=20,
                          dtype=torch.float32, device="cpu", **_SIM)
    b0 = torch.zeros(6)
    pre = vis.preintegrate_segments(sim, b0[:3], b0[3:], sigma_g=2e-4,
                                    sigma_a=2e-3)
    out = vc.solve_vi_chain(pre, sim.obs_poses, sim.obs_poses, sim.vels_true,
                            b0, max_iters=25, **_SIG)
    assert out.poses.t.dtype == out.cost.dtype == torch.float32
    ate_obs = float(metrics.ate_translation_rmse(sim.obs_poses,
                                                 sim.poses_true))
    ate = float(metrics.ate_translation_rmse(out.poses, sim.poses_true))
    assert ate < 0.7 * ate_obs, (ate, ate_obs)


def test_chain_needs_two_keyframes(k8):
    _, _, tsim, tpre, *_ = k8
    one = type(tsim.obs_poses)(tsim.obs_poses.R[:1], tsim.obs_poses.t[:1])
    with pytest.raises(ValueError):
        vc.solve_vi_chain(tpre, one, one, tsim.vels_true[:1],
                          torch.zeros(6, dtype=torch.float64))
