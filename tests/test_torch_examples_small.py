"""The port's small examples (slam_tricks_tpu_torch.examples: ba_demo,
calibration_demo, pnp_demo, two_view_demo) against the JAX package's
examples/*.py, both run with --cpu (float64) in this process; the JAX side's
numbers are the arguments of its log records (full precision), collected by
a handler of the test's own.

- ba_demo (--cams 8 --per-wall 20): the JAX script fails under its own
  jax.jit (examples/ba_demo.py:53-54 passes the callback as an array), so
  it is held against the JAX package's schur.solve_ba, called without jit,
  on make_scene's scene (the same bits: tests/test_torch_ba_scene.py): the
  callback's costs iteration by iteration to rtol 1e-8 over the iterations
  both ran (both reach the optimum's plateau, 1.3056e-4, by iteration 3;
  there the cost moves by ulps and the stop decisions differ: the port
  stops after ~15, JAX runs all 30), the final cost, ATE, reprojection RMS,
  poses and points to 1e-8; main writes both PNGs;
- calibration_demo: the RMS to rtol 1e-12, the intrinsics to rtol 1e-8,
  the distortion to atol 1e-8: both sit on the optimum's plateau long
  before they stop (the port after 23 to 68 iterations with the CPU
  BLAS's thread count, JAX after 60), where the cost moves by ulps and
  the poorly conditioned distortion terms wander by up to 5e-9 (p2, of
  size 7e-4, by 1e-7 relative); the iteration counts are not compared;
- calibration_demo --calib-dir: the synthetic scene's views written as
  corner files (1e-3 px) calibrate to the JAX example's intrinsics within
  0.01 px; an empty directory is refused;
- pnp_demo: every cost at the f64 floor (atol 1e-20, as ROADMAP.md's known
  properties; the iteration counts are not compared there), the port's
  poses within 1e-10 of the truth;
- two_view_demo: cheirality votes equal, the rotation, translation and
  depth errors and the refined cost to rtol 1e-8;
- an example without --cpu on a machine without CUDA raises.
"""

import numpy as np
import pytest
import torch

from slam_tricks_tpu.evaluation import metrics as jmetrics
from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import schur as jschur
from slam_tricks_tpu_torch.examples import (ba_demo, calibration_demo,
                                            pnp_demo, two_view_demo)
from slam_tricks_tpu_torch.sim.calib_scene import make_calib_scene
from slam_tricks_tpu_torch.utils.io import write_cbcorners
from tests.torch_util import rel_err, run_jax_example, run_port_example

RTOL = 1e-8
FLOOR_ATOL = 1e-20
DIST_ATOL = 1e-8
CORNER_FILE_PX = 0.01


def _close(a, b, rtol=RTOL, atol=0.0):
    assert abs(a - b) <= atol + rtol * abs(b), (a, b)


@pytest.fixture(scope="module")
def jax_ba():
    """The JAX package's solve_ba (no jit) on ba_demo's --cpu --cams 8
    --per-wall 20 scene: (per-iteration costs, state, initial ATE, final
    ATE, RMS)."""
    import jax

    sc = jmake_scene(n_per_wall=20, n_cams=8, pix_noise=1e-3,
                     dtype=np.float64)
    poses0, points0, fixed = jperturb_scene(sc)
    costs = []
    final = jschur.solve_ba(poses0, points0, sc.obs, fixed_mask=fixed,
                            max_iters=30,
                            callback=lambda it, c, lam: costs.append(
                                (int(it), float(c))))
    jax.block_until_ready(final)
    ate0 = float(jmetrics.ate_translation_rmse(poses0, sc.poses_true))
    ate = float(jmetrics.ate_translation_rmse(final.poses, sc.poses_true))
    rms = float(jmetrics.reprojection_rms(final.poses, final.points,
                                          sc.obs.cam_idx, sc.obs.lm_idx,
                                          sc.obs.uv, sc.obs.weight))
    n_obs = int(np.sum(np.asarray(sc.obs.weight) > 0))
    return {"costs": [c for _, c in sorted(costs)], "state": final,
            "initial_ate": ate0, "final_ate": ate, "rms": rms,
            "n_obs": n_obs}


def test_ba_demo_matches_jax_solve_ba(jax_ba, tmp_path):
    out, records, _ = run_port_example(
        ba_demo, ["--cpu", "--cams", "8", "--per-wall", "20", "--out",
                  str(tmp_path)])
    assert out["n_obs"] == jax_ba["n_obs"] and records[0][2] == out["n_obs"]
    _close(out["initial_ate"], jax_ba["initial_ate"], 1e-12)
    n = min(len(out["costs"]), len(jax_ba["costs"]))
    assert n >= 10 and out["iters"] == len(out["costs"])
    for a, b in zip(out["costs"][:n], jax_ba["costs"][:n]):
        _close(a, b)
    _close(out["final_cost"], float(jax_ba["state"].cost))
    _close(out["final_ate"], jax_ba["final_ate"])
    _close(out["reprojection_rms"], jax_ba["rms"])
    state = out["state"]
    assert rel_err(state.poses.t, jax_ba["state"].poses.t) < 1e-8
    assert rel_err(state.points, jax_ba["state"].points) < 1e-8
    for png in out["images"]:
        assert png.startswith(str(tmp_path)) and (
            tmp_path / png.rsplit("/", 1)[1]).stat().st_size > 100
    # the logged numbers are the returned ones: the scene, the start's
    # ATE, then one record an iteration
    logged = records[2:2 + out["iters"]]
    assert [(it, c) for it, c, _ in logged] == list(enumerate(out["costs"]))


@pytest.fixture(scope="module")
def jax_calibration():
    records, _ = run_jax_example("calibration_demo", ["--cpu"], "calib_demo")
    return records


def test_calibration_demo_matches_jax(jax_calibration):
    out, records, _ = run_port_example(calibration_demo, ["--cpu"],
                                       "calib_demo")
    assert len(records) == len(jax_calibration) == 4
    assert records[0] == jax_calibration[0] == ()       # synthetic dataset
    (rms, iters), K, dist = jax_calibration[1:]
    _close(out["rms_px"], rms, 1e-12)
    assert out["iterations"] <= 80 and iters <= 80
    for k, v in zip(("fx", "fy", "cx", "cy"), K):
        _close(out[k], v)
    for k, v in zip(("k1", "k2", "k3", "p1", "p2"), dist):
        _close(out[k], v, rtol=0.0, atol=DIST_ATOL)
    assert records[1:] == [(out["rms_px"], out["iterations"]),
                           tuple(out[k] for k in ("fx", "fy", "cx", "cy")),
                           tuple(out[k] for k in ("k1", "k2", "k3", "p1",
                                                  "p2"))]


def test_calibration_demo_reads_corner_files(jax_calibration, tmp_path):
    scene = make_calib_scene(n_views=9, noise=0.1, device="cpu")
    for i, view in enumerate(scene.image_pts.numpy()):
        write_cbcorners(str(tmp_path / f"view_{i:02d}.txt"), 5, 8, view)
    out, records, _ = run_port_example(
        calibration_demo, ["--cpu", "--calib-dir", str(tmp_path)],
        "calib_demo")
    assert out["dataset"] == "corners" and records[0] == (9, 5, 8)
    # the synthetic views written to 1e-3 px: the JAX example's intrinsics
    for k, v in zip(("fx", "fy", "cx", "cy"), jax_calibration[2]):
        assert abs(out[k] - v) < CORNER_FILE_PX, (k, out[k], v)
    with pytest.raises(FileNotFoundError):
        calibration_demo.main(["--cpu", "--calib-dir",
                               str(tmp_path / "none")])


@pytest.fixture(scope="module")
def jax_pnp():
    records, _ = run_jax_example("pnp_demo", ["--cpu"])
    return records


def test_pnp_demo_matches_jax(jax_pnp):
    out, records, _ = run_port_example(pnp_demo, ["--cpu"])
    assert len(records) == len(jax_pnp) == 4
    (_, lm_cost, lm_iters), (_, gn_cost), (_, an_cost), (B, _, _, bmax) = \
        jax_pnp
    assert B == out["batch"] == 8192
    for got, ref in ((out["lm_cost"], lm_cost), (out["gn_cost"], gn_cost),
                     (out["analytic_cost"], an_cost),
                     (out["batch_max_cost"], bmax)):
        _close(got, ref, atol=FLOOR_ATOL)
    assert out["pose_err"] < 1e-10 and out["batch_pose_err"] < 1e-10
    assert 1 <= out["lm_iters"] <= 40 and 1 <= lm_iters <= 40


@pytest.fixture(scope="module")
def jax_two_view():
    records, _ = run_jax_example("two_view_demo", ["--cpu"])
    return records


def test_two_view_demo_matches_jax(jax_two_view):
    out, records, _ = run_port_example(two_view_demo, ["--cpu"])
    assert len(records) == len(jax_two_view) == 4
    (n_ch,), (rot, t), (dmed, dmax), (cost,) = jax_two_view
    assert out["n_cheiral"] == n_ch == 100
    for k, v in (("rot_err", rot), ("t_err", t), ("depth_err_median", dmed),
                 ("depth_err_max", dmax), ("final_cost", cost)):
        _close(out[k], v)


def test_example_without_cpu_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        two_view_demo.main([])
