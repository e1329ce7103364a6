"""The port's calibration and two-view pipelines
(slam_tricks_tpu_torch/pipelines) and their simulators against the JAX
package's, on the same inputs, in f64:

- sim: make_calib_scene (with distortion and noise) and make_two_view
  (with noise) against the JAX package's: the same numpy sequence, arrays
  to 1e-12 (the projections in f64, another summation order);
- calibrate on make_calib_scene(n_views=6, seed=9) (noiseless; n = 45 >
  16, so its normal systems go through spd_solve's plain version): at 4
  iterations the same count, cost rtol 1e-8 (atol 1e-20: both reach the
  f64 floor, ~1e-25, by then), intrinsics and poses to 1e-9
  relative; at 40 both at the f64 floor (RMS < 1e-8, the JAX test's gate,
  fx within 1e-5 of 600) with the intrinsics to 1e-9 relative; init= with
  the JAX package's closed-form start, and a noisy, distorted scene
  (seed 8, 9 views) at 8 iterations, cost rtol 1e-8;
- solve_two_view on make_two_view(60, noise=1e-4, seed=4) (the JAX
  package's test_two_view_pipeline): T_12 and the points within 1e-9,
  the cost to rtol 1e-8, n_cheiral equal, at refine_iters 20 and 0;
  weights, and a point pushed behind the cameras (weight 0, no live slot:
  the same result as the JAX package's zero-weight slot); the layout is a
  (K = 2, L = N) grid.

Each JAX reference runs once a module under jax.jit and is waited for
before the port runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.initialization.zhang import calibrate_closed_form
from slam_tricks_tpu.pipelines.calibration import calibrate as jcalibrate
from slam_tricks_tpu.pipelines.two_view import solve_two_view as jtwo_view
from slam_tricks_tpu.residuals.camera import DistCoeffs as JDist
from slam_tricks_tpu.sim.calib_scene import make_calib_scene as jcalib_scene
from slam_tricks_tpu.sim.two_view import make_two_view as jmake_two_view
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.pipelines import calibration, two_view
from slam_tricks_tpu_torch.residuals.camera import DistCoeffs
from slam_tricks_tpu_torch.sim import make_calib_scene, make_two_view
from tests.torch_util import rel_err

_DIST = (-0.25, 0.07, 0.0, 1e-4, -5e-5)


def test_scenes_match_jax():
    js = jcalib_scene(n_views=9, noise=0.1, seed=8,
                      dist=JDist(*map(jnp.float64, _DIST)))
    ts = make_calib_scene(n_views=9, noise=0.1, seed=8,
                          dist=DistCoeffs(*_DIST), device="cpu")
    assert rel_err(ts.board_pts, js.board_pts) == 0.0
    assert rel_err(ts.image_pts, js.image_pts) < 1e-12
    assert rel_err(ts.poses_true.R, js.poses_true.R) == 0.0
    assert rel_err(ts.poses_true.t, js.poses_true.t) == 0.0
    assert (ts.fx, ts.fy, ts.cx, ts.cy) == (js.fx, js.fy, js.cx, js.cy)
    f32 = make_calib_scene(n_views=3, seed=1, dtype=torch.float32,
                           device="cpu")
    assert f32.image_pts.dtype == torch.float32
    jv = jmake_two_view(n_points=50, noise=1e-3, seed=2)
    tv = make_two_view(n_points=50, noise=1e-3, seed=2, device="cpu")
    for a, b in ((tv.points, jv.points), (tv.uv1, jv.uv1), (tv.uv2, jv.uv2),
                 (tv.T_12.R, jv.T_12.R), (tv.T_12.t, jv.T_12.t)):
        assert rel_err(a, b) < 1e-12


@pytest.fixture(scope="module")
def calib9():
    js = jcalib_scene(n_views=6, noise=0.0, seed=9)
    run = jax.jit(lambda b, i, mi: jcalibrate(b, i, max_iters=mi),
                  static_argnums=2)
    refs = {mi: jax.block_until_ready(run(js.board_pts, js.image_pts, mi))
            for mi in (4, 40)}
    return js, interop.calib_scene_from_jax(js, "cpu"), refs


def _check_calib(res, ref, V, tol=1e-9):
    for a, b in zip((*res.intrinsics, *res.distortion),
                    (*ref.intrinsics, *ref.distortion)):
        assert abs(float(a) - float(b)) <= tol * max(abs(float(b)), 1.0)
    assert rel_err(res.poses.R, ref.poses.R) < tol
    assert rel_err(res.poses.t, ref.poses.t) < tol
    assert res.poses.R.shape == (V, 3, 3)


def test_calibrate_matches_jax(calib9):
    js, ts, refs = calib9
    res = calibration.calibrate(ts.board_pts, ts.image_pts, max_iters=4)
    assert res.iterations == int(refs[4].iterations) == 4
    np.testing.assert_allclose(float(res.final_cost),
                               float(refs[4].final_cost), rtol=1e-8,
                               atol=1e-20)      # ~1e-25: the f64 floor
    _check_calib(res, refs[4], 6)
    res = calibration.calibrate(ts.board_pts, ts.image_pts, max_iters=40)
    ref = refs[40]
    assert float(res.rms_px) < 1e-8 and float(ref.rms_px) < 1e-8
    assert abs(float(res.intrinsics.fx) - ts.fx) < 1e-5
    _check_calib(res, ref, 6)


def test_calibrate_with_init_and_distortion():
    js = jcalib_scene(n_views=9, noise=0.1, seed=8,
                      dist=JDist(*map(jnp.float64, _DIST)))
    jintr, _, jposes = calibrate_closed_form(js.board_pts, js.image_pts)
    ref = jax.block_until_ready(jax.jit(lambda b, i: jcalibrate(
        b, i, max_iters=8, init=(jintr, jposes)))(js.board_pts,
                                                  js.image_pts))
    ts = interop.calib_scene_from_jax(js, "cpu")
    init = (interop.intrinsics_from_jax(jintr, "cpu"),
            interop.poses_from_jax(jposes, "cpu"))
    res = calibration.calibrate(ts.board_pts, ts.image_pts, max_iters=8,
                                init=init)
    assert res.iterations == int(ref.iterations)
    np.testing.assert_allclose(float(res.final_cost), float(ref.final_cost),
                               rtol=1e-8)
    _check_calib(res, ref, 9, tol=1e-8)


@pytest.fixture(scope="module")
def tv60():
    js = jmake_two_view(n_points=60, noise=1e-4, seed=4)
    run = jax.jit(lambda a, b, w, ri: jtwo_view(a, b, refine_iters=ri,
                                                weights=w),
                  static_argnums=3)
    w = np.random.default_rng(5).uniform(0.5, 1.5, 60)
    uv2_bad = np.array(js.uv2)
    uv2_bad[7] = [-2.0, 3.0]              # triangulates behind a camera
    refs = {
        "20": run(js.uv1, js.uv2, None, 20),
        "0": run(js.uv1, js.uv2, None, 0),
        "w": run(js.uv1, js.uv2, jnp.asarray(w), 20),
        "bad": run(js.uv1, jnp.asarray(uv2_bad), None, 20),
    }
    return js, interop.two_view_from_jax(js, "cpu"), w, uv2_bad, \
        jax.block_until_ready(refs)


def _check_two_view(res, ref):
    assert rel_err(res.T_12.R, ref.T_12.R) < 1e-9
    assert rel_err(res.T_12.t, ref.T_12.t) < 1e-9
    assert rel_err(res.points, ref.points) < 1e-9
    np.testing.assert_allclose(float(res.final_cost), float(ref.final_cost),
                               rtol=1e-8)
    assert float(res.n_cheiral) == pytest.approx(float(ref.n_cheiral),
                                                 rel=1e-14)


@pytest.mark.parametrize("case", ["20", "0", "w", "bad"])
def test_solve_two_view_matches_jax(tv60, case):
    js, ts, w, uv2_bad, refs = tv60
    uv2 = torch.as_tensor(uv2_bad) if case == "bad" else ts.uv2
    res = two_view.solve_two_view(
        ts.uv1, uv2, refine_iters=0 if case == "0" else 20,
        weights=torch.as_tensor(w) if case == "w" else None)
    _check_two_view(res, refs[case])
    if case == "20":
        t_ref = ts.T_12.t / ts.T_12.t.norm()
        assert float((res.T_12.R - ts.T_12.R).abs().max()) < 2e-3
        assert float((res.T_12.t - t_ref).abs().max()) < 2e-3
        assert float(res.final_cost) <= float(refs["0"].final_cost)
    if case == "bad":      # points behind a camera: weight 0, no live slot
        assert float(res.n_cheiral) < 60


def test_two_view_work_layout(tv60):
    _, ts, *_ = tv60
    w = torch.ones(60, dtype=torch.float64)
    w[3] = 0.0
    work = two_view.two_view_work(ts.uv1, ts.uv2, w)
    assert work.w.shape == (2, 60) and work.n_cams == 2
    live = work.mask > 0           # a padding slot carries camera 0
    assert work.cam_of_slot[0].eq(0).all()
    assert work.cam_of_slot[1][live[1]].eq(1).all()
    uv0 = torch.stack([ts.uv1[:, 0], ts.uv2[:, 0]])
    assert torch.equal(work.uv0[live], uv0[live])
    assert work.mask[:, 3].eq(0).all() and work.mask.sum() == 118
