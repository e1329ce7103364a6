"""lambda_init= and xtol= of the port's two solvers, at values other than
the defaults (1e-4 and 1e-12), against the JAX package's solve_ba_flat_sm
and solve_ba_banded, in f64: lambda_init=1e-2, and an xtol that stops the
solve before max_iters=15 on a step far above the f64 floor: 1e-3 on path
A (after 6 iterations), 1.0 on path B (after 2), whose noisy trajectory
keeps steps of norm ~1 along its weakly held scale.

Path A on the noisy 16-camera cube-room scene, path B on a noisy 16-camera
trajectory with tracks of 4 (K = 3: its JAX solve compiles in about half
the time of the K = 6 scene of tests/test_banded_flat.py). Tolerances as
tests/test_torch_schur_flat_sm.py and tests/test_torch_banded_flat.py hold
the two paths: the same iteration
count and stop flag; path A cost rtol 1e-6 (atol 1e-20), poses and points
to 1e-8; path B cost rtol 1e-7 (atol 1e-20), rotations 1e-9, points 1e-8,
translations 1e-10 of their largest entry."""

import numpy as np

from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import banded_flat as jbf
from slam_tricks_tpu.solvers import schur_flat_sm as jsm
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.solvers import banded_flat, schur_flat_sm
import tests.torch_util  # noqa: F401  (caps torch's threads)

OPTIONS = dict(max_iters=15, lambda_init=1e-2)


def _port_state(jp0, jx0, jfx):
    return (interop.poses_from_jax(jp0, "cpu"), interop.tensor(jx0, "cpu"),
            interop.tensor(jfx, "cpu"))


def test_path_a_lambda_init_and_xtol_match_jax():
    jsc = jmake_scene(n_per_wall=60, n_cams=16, seed=3, pix_noise=1e-3,
                      dtype=np.float64)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=4)
    jwork = jsm.build_slot_work(jsc.obs, jsc.n_cams, jsc.n_points,
                                dtype=np.float64)
    ref = jsm.solve_ba_flat_sm(jp0, jx0, jwork, fixed_mask=jfx, xtol=1e-3,
                               **OPTIONS)
    p0, x0, fx = _port_state(jp0, jx0, jfx)
    out = schur_flat_sm.solve_ba_flat_sm(
        p0, x0, interop.slot_work_from_jax(jwork, "cpu"), fixed_mask=fx,
        xtol=1e-3, **OPTIONS)
    assert (out.it, out.done) == (int(ref.it), bool(ref.done))
    assert out.done and out.it < OPTIONS["max_iters"]
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6,
                               atol=1e-20)
    for a, b in ((out.poses.R, ref.poses.R), (out.poses.t, ref.poses.t),
                 (out.points, ref.points)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


def test_path_b_lambda_init_and_xtol_match_jax():
    jsc = jmake_trajectory(n_cams=16, n_points=300, track_len=4, seed=79,
                           pix_noise=1e-3, dtype=np.float64)
    jp0, jx0, jfx = jperturb_scene(jsc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=80)
    jbw = jbf.build_banded_work(jsc.obs, jsc.n_cams, jsc.n_points,
                                dtype=np.float64)
    ref = jbf.solve_ba_banded(jp0, jx0, jbw, fixed_mask=jfx, xtol=1.0,
                              **OPTIONS)
    p0, x0, fx = _port_state(jp0, jx0, jfx)
    out = banded_flat.solve_ba_banded(
        p0, x0, interop.banded_work_from_jax(jbw, jsc.n_points, "cpu"),
        fixed_mask=fx, xtol=1.0, **OPTIONS)
    assert (out.it, out.done) == (int(ref.it), bool(ref.done))
    assert out.done and out.it < OPTIONS["max_iters"]
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-7,
                               atol=1e-20)
    np.testing.assert_allclose(out.poses.R.numpy(), np.asarray(ref.poses.R),
                               rtol=0, atol=1e-9)
    t_ref = np.asarray(ref.poses.t)
    np.testing.assert_allclose(out.poses.t.numpy(), t_ref, rtol=0,
                               atol=1e-10 * np.abs(t_ref).max())
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points),
                               rtol=0, atol=1e-8)
