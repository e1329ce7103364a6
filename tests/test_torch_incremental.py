"""The incremental smoother, slam_tricks_tpu_torch/solvers/incremental.py,
against the JAX package's solvers/incremental.py, in f64, on the
trajectory of tests/test_incremental.py (32 cameras, 480 landmarks,
tracks of 4, seed 11) with pix_noise=1e-3 and the small perturbation of
the other trajectory tests (0.002, 0.01, 0.01), streamed
[16, 20, 24, 28, 32] with gn_steps=2.

Cameras 0 and 15 are fixed: with camera 0 alone (the smoothers' default)
the 16-camera start holds no scale, and the two packages' starting
solutions drift apart along it by ~1e-5 (each is as good as the other);
two fixed cameras hold it, and the starts agree to 1e-9.

Tolerances: active_weight equal; one gn_step_stored from the same state,
with a stored factor extended from c_changed = 12: dp and dl to 1e-9
(as one banded step, tests/test_torch_banded_flat.py), the factor's
blocks and the cost to 1e-9 relative; the stream: the same c_dirty after
each arrival, final cost rtol 1e-7, translations to 1e-8 and points to
1e-7 (the tail-restricted Gauss-Newton steps carry the start's 1e-9 on;
the arrivals' backtracking takes the same step lengths in both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import banded_flat as jbf
from slam_tricks_tpu.solvers import incremental as jinc
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.solvers import banded_flat, incremental
import tests.torch_util  # noqa: F401  (caps torch's threads)

SCHEDULE = [16, 20, 24, 28, 32]


@pytest.fixture(scope="module")
def stream():
    """Both streams, and each state and c_dirty along them."""
    jsc = jmake_trajectory(n_cams=32, n_points=480, track_len=4, seed=11,
                           pix_noise=1e-3, dtype=np.float64)
    jp0, jx0, _ = jperturb_scene(jsc, pose_rot_noise=0.002,
                                 pose_trans_noise=0.01, point_noise=0.01,
                                 seed=12)
    jbw = jbf.build_banded_work(jsc.obs, 32, 480, dtype=np.float64)
    sc_fixed = np.zeros(32, bool)
    sc_fixed[[0, 15]] = True
    bw = interop.banded_work_from_jax(jbw, 480, "cpu")
    out = {"jbw": jbw, "bw": bw, "jfx": jnp.asarray(sc_fixed),
           "fx": torch.as_tensor(sc_fixed)}
    for side, init, arrive, args in (
            ("jax", jinc.smoother_init, jinc.smoother_arrive,
             (jp0, jx0, jbw, out["jfx"])),
            ("port", incremental.smoother_init, incremental.smoother_arrive,
             (interop.poses_from_jax(jp0, "cpu"), interop.tensor(jx0, "cpu"),
              bw, out["fx"]))):
        p0, x0, work, fixed = args
        state, c_dirty = init(p0, x0, work, n_active=SCHEDULE[0],
                              fixed_mask=fixed)
        states = [(state, c_dirty)]
        for a_prev, a_new in zip(SCHEDULE[:-1], SCHEDULE[1:]):
            state, c_dirty = arrive(state, work, a_prev=a_prev, a_new=a_new,
                                    c_dirty=c_dirty, fixed_mask=fixed,
                                    gn_steps=2)
            states.append((state, c_dirty))
        out[side] = states
    return out


@pytest.mark.parametrize("n_active", [16, 29, 32])
def test_active_weight_matches_jax(stream, n_active):
    np.testing.assert_array_equal(
        incremental.active_weight(stream["bw"], n_active).numpy(),
        np.asarray(jinc.active_weight(stream["jbw"], n_active)))


def test_gn_step_stored_matches_jax(stream):
    """The first arrival's step from the JAX start, both factors extended
    from the JAX start's stored factor."""
    (jstate, _), = stream["jax"][:1]
    ref = jinc.gn_step_stored(jstate.poses, jstate.points_s, stream["jbw"],
                              32, lam=1e-4, fixed_mask=stream["jfx"],
                              n_active=20, fac_prev=jstate.fac, c_changed=12)
    fac = banded_flat.TridiagFactor(L=interop.tensor(jstate.fac.L, "cpu"),
                                    F=interop.tensor(jstate.fac.F, "cpu"))
    out = incremental.gn_step_stored(
        interop.poses_from_jax(jstate.poses, "cpu"),
        interop.tensor(jstate.points_s, "cpu"), stream["bw"], lam=1e-4,
        fixed_mask=stream["fx"], n_active=20, fac_prev=fac, c_changed=12)
    for label, a, b in (("dp", out[0], ref[0]), ("dl", out[1], ref[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9, err_msg=label)
    for label, a, b in (("L", out[2].L, ref[2].L), ("F", out[2].F, ref[2].F)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-9 * np.abs(b).max(), err_msg=label)
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=1e-9)


def test_stream_matches_jax(stream):
    for (js, jc), (ts, tc) in zip(stream["jax"], stream["port"]):
        assert tc == jc
    (js, _), (ts, _) = stream["jax"][-1], stream["port"][-1]
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-7)
    np.testing.assert_allclose(ts.poses.t.numpy(), np.asarray(js.poses.t),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts.points_s.numpy(), np.asarray(js.points_s),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        incremental.scatter_points(ts.points_s, stream["bw"], 480).numpy(),
        np.asarray(jinc.scatter_points(js.points_s, stream["jbw"], 480)),
        rtol=0, atol=1e-7)


def test_start_matches_jax(stream):
    (js, jc), (ts, tc) = stream["jax"][0], stream["port"][0]
    assert tc == jc == 32
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-9)
    np.testing.assert_allclose(ts.poses.t.numpy(), np.asarray(js.poses.t),
                               rtol=0, atol=1e-9)
    L = np.asarray(js.fac.L)
    np.testing.assert_allclose(ts.fac.L.numpy(), L, rtol=0,
                               atol=1e-9 * np.abs(L).max())
