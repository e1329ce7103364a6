"""IMU preintegration of the port (slam_tricks_tpu_torch/estimation/
preintegration.py, the simulators and dead reckoning of vi_smoother.py)
against the JAX package's, on the same numpy inputs:

- preintegrate on a batch of segments (the port loops over the samples
  on batched tensors, the JAX package scans and vmaps), every field of
  PreintegratedImu: f64 to 1e-12 relative, f32 to 1e-5 (f32 rounding
  along 40 steps of 3x3 products, in another order);
- bias_corrected, imu_residual and whiten at a state off the truth and
  at biases off the integration's: f64 1e-12 (the residual relative to
  its largest entry), f32 1e-5; the port's whitener (L^-1 formed once)
  against JAX's whiten (a triangular solve) to 1e-12;
- simulate_vi and simulate_vi_landmarks in f64 to 1e-12 (the same numpy
  draws; the closed form computed by each package), through
  interop.vi_sim_from_jax exactly;
- dead_reckon in f64 to 1e-12;
- the zero-noise residual at the truth below 5e-5 (the JAX package's own
  bound, tests/test_preintegration.py:37), on the port's simulation;
- importing the estimation package and interop leaves jax out.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.estimation import preintegration as jpim
from slam_tricks_tpu.estimation import vi_smoother as jvis
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu.manifolds import so3 as jso3
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.estimation import preintegration as pim
from slam_tricks_tpu_torch.estimation import vi_smoother as vis
from slam_tricks_tpu_torch.manifolds import se3
from tests.torch_util import rel_err

_REPO = Path(__file__).resolve().parents[1]
_SIM = dict(n_keyframes=10, samples_per_seg=40, dt=0.0025, sigma_g=2e-4,
            sigma_a=2e-3, seed=5)
_TOL = {np.float64: 1e-12, np.float32: 1e-5}
_TDT = {np.float64: torch.float64, np.float32: torch.float32}
_BG = np.array([0.01, 0.02, -0.01])
_BA = np.array([0.05, -0.02, 0.1])


@pytest.fixture(scope="module")
def jsim():
    return jvis.simulate_vi(**_SIM)


def _jpre(jsim, dtype, bg=_BG, ba=_BA):
    g, a = np.asarray(jsim.gyro, dtype), np.asarray(jsim.accel, dtype)
    return jax.block_until_ready(jax.jit(jax.vmap(
        lambda w, f: jpim.preintegrate(w, f, jsim.dt, bg.astype(dtype),
                                       ba.astype(dtype), sigma_g=2e-4,
                                       sigma_a=2e-3)))(g, a))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_preintegrate_matches_jax(dtype, jsim):
    want = _jpre(jsim, dtype)
    T_ = lambda a: torch.as_tensor(np.array(a, dtype))  # noqa: E731
    got = pim.preintegrate(T_(jsim.gyro), T_(jsim.accel), jsim.dt, T_(_BG),
                           T_(_BA), sigma_g=2e-4, sigma_a=2e-3)
    for name in pim.PreintegratedImu._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(a.shape) == b.shape and a.dtype == _TDT[dtype], name
        assert rel_err(a, b) < _TOL[dtype], name


def test_preintegrate_one_segment_and_per_sample_dt(jsim):
    """An unbatched (S, 3) stream and an (S,) dt, as the JAX function
    takes them."""
    dts = np.full(40, jsim.dt) * (1.0 + 0.1 * np.sin(np.arange(40)))
    want = jpim.preintegrate(jsim.gyro[2], jsim.accel[2], dts, _BG, _BA)
    got = pim.preintegrate(interop.tensor(jsim.gyro[2], "cpu"),
                           interop.tensor(jsim.accel[2], "cpu"),
                           torch.as_tensor(dts), torch.as_tensor(_BG),
                           torch.as_tensor(_BA))
    for name in pim.PreintegratedImu._fields:
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-12, name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_residual_and_whiten_match_jax(dtype, jsim):
    pre_j = _jpre(jsim, dtype, bg=np.zeros(3), ba=np.zeros(3))
    pre = interop.preintegrated_from_jax(pre_j, device="cpu")
    rng = np.random.default_rng(1)
    K = jsim.vels_true.shape[0]
    R = np.asarray(jax.vmap(jso3.exp)(jnp.asarray(
        rng.normal(0, 0.01, (K, 3))))) @ np.asarray(jsim.poses_true.R)
    t = np.asarray(jsim.poses_true.t) + rng.normal(0, 0.02, (K, 3))
    v = np.asarray(jsim.vels_true) + rng.normal(0, 0.05, (K, 3))
    bg, ba = (np.asarray(jsim.bg_true) + 0.003, np.asarray(jsim.ba_true)
              - 0.01)
    R, t, v, bg, ba = (a.astype(dtype) for a in (R, t, v, bg, ba))
    Ti, Tj = jse3.SE3(R[:-1], t[:-1]), jse3.SE3(R[1:], t[1:])
    r_j = jax.vmap(lambda p, a, vi, b, vj: jpim.imu_residual(
        p, a, vi, b, vj, bg, ba))(pre_j, Ti, v[:-1], Tj, v[1:])
    w_j = jax.vmap(jpim.whiten)(pre_j, r_j)
    c_j = jax.vmap(lambda p: jpim.bias_corrected(p, bg, ba))(pre_j)
    T_ = lambda a: torch.as_tensor(a)  # noqa: E731
    r = pim.imu_residual(pre, se3.SE3(T_(R[:-1]), T_(t[:-1])), T_(v[:-1]),
                         se3.SE3(T_(R[1:]), T_(t[1:])), T_(v[1:]), T_(bg),
                         T_(ba))
    w = pim.whiten(pre, r)
    c = pim.bias_corrected(pre, T_(bg), T_(ba))
    for a, b in zip((r, w, *c), (r_j, w_j, *c_j)):
        assert rel_err(a, b) < _TOL[dtype]
    if dtype == np.float64:
        Linv = pim.whitener(pre, torch.float64)
        assert rel_err((Linv @ r[..., None])[..., 0], w_j) < 1e-12


def test_simulators_match_jax_f64(jsim):
    sim = vis.simulate_vi(device="cpu", **_SIM)
    conv = interop.vi_sim_from_jax(jsim, device="cpu")
    assert sim.dt == conv.dt == jsim.dt
    for name in ("vels_true", "gyro", "accel", "bg_true", "ba_true"):
        a, b = getattr(sim, name), np.asarray(getattr(jsim, name))
        assert a.dtype == torch.float64 and tuple(a.shape) == b.shape, name
        assert rel_err(a, b) < 1e-12, name
        assert np.array_equal(getattr(conv, name).numpy(), b), name
    for name in ("poses_true", "obs_poses"):
        for f in ("R", "t"):
            a = getattr(getattr(sim, name), f)
            assert rel_err(a, getattr(getattr(jsim, name), f)) < 1e-12
    pts_j, uv_j, w_j = jvis.simulate_vi_landmarks(jsim, n_landmarks=60,
                                                  uv_noise=5e-4, seed=2)
    pts, uv, w = vis.simulate_vi_landmarks(conv, n_landmarks=60,
                                           uv_noise=5e-4, seed=2)
    assert rel_err(pts, pts_j) < 1e-12 and rel_err(uv, uv_j) < 1e-12
    assert np.array_equal(w.numpy(), np.asarray(w_j))


def test_dead_reckon_matches_jax(jsim):
    pre_j = _jpre(jsim, np.float64)
    T0 = jax.tree_util.tree_map(lambda a: a[0], jsim.poses_true)
    poses_j, vels_j = jvis.dead_reckon(pre_j, T0, jsim.vels_true[0], _BG,
                                       _BA)
    pre = interop.preintegrated_from_jax(pre_j, device="cpu")
    T0t = se3.SE3(interop.tensor(T0.R, "cpu"), interop.tensor(T0.t, "cpu"))
    poses, vels = vis.dead_reckon(pre, T0t,
                                  interop.tensor(jsim.vels_true[0], "cpu"),
                                  torch.as_tensor(_BG), torch.as_tensor(_BA))
    assert rel_err(poses.R, poses_j.R) < 1e-12
    assert rel_err(poses.t, poses_j.t) < 1e-12
    assert rel_err(vels, vels_j) < 1e-12


def test_zero_noise_residual_is_zero():
    """The exact stream, the true states and biases: the residual is the
    integrator's O(dt^2) error alone."""
    sim = vis.simulate_vi(n_keyframes=10, samples_per_seg=40, dt=0.0025,
                          device="cpu")
    pre = vis.preintegrate_segments(sim, sim.bg_true, sim.ba_true)
    P, v = sim.poses_true, sim.vels_true
    r = pim.imu_residual(pre, se3.SE3(P.R[:-1], P.t[:-1]), v[:-1],
                         se3.SE3(P.R[1:], P.t[1:]), v[1:], sim.bg_true,
                         sim.ba_true)
    assert float(r.abs().max()) < 5e-5


def test_import_leaves_jax_out():
    code = ("import sys, slam_tricks_tpu_torch.estimation, "
            "slam_tricks_tpu_torch.solvers.lm, slam_tricks_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'slam_tricks_tpu']; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
