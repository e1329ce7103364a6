"""The distributed solvers, slam_tricks_tpu_torch/parallel/, run on gloo
ranks on the CPU (one process a rank, spawned once for each module-scoped
fixture, joined through a file:// store under the test's temporary
directory), against the JAX package's distributed solvers of the same
names on the conftest's 8-device CPU mesh, in f64, on the JAX tests'
problems:

- banded_dist and pcg_dist: tests/test_multihost.py's trajectory (16
  cameras, 240 landmarks, tracks of 4, seed 73, perturbed with seed 74),
  8 and 5 iterations; banded_dist at D = 2 and at D = 3 (an uneven split,
  pad chunks on the last rank); PCG with cg_iters 200 and cg_tol 1e-12
  (CG amplifies the summation order);
- sharded and landmark_local: the cube room of tests/test_landmark_local.py
  (make_scene(n_per_wall=10, n_cams=6, seed=51)) with pix_noise 1e-3, 4
  iterations: the cost has settled to 7 digits there, and from the 6th
  step on it moves by ulps, where an accept or reject flips with the
  summation order (the poses then move by ~1e-9);
- loop_dist: the smallest loop scene of tests/test_loop_dist.py (32
  cameras, 600 landmarks, tracks of 4, seed 97, max_band 4), 6 iterations;
- banded_dist with tukey(0.02) on tests/test_banded_dist.py's robust
  problem (one observation in 50 moved by N(0, 0.3)), 8 iterations.

Tolerances are those tests' own: iteration counts equal, cost rtol 1e-7,
poses atol 1e-9, points atol 1e-8 (Tukey: cost rtol 1e-6, poses 1e-7).
Also: every rank returns the same bits; a group of one rank gives the bits
of the single-process solve (psum_axis=None); and the all_reduce operands
of the f32 banded, loop and PCG solves, recorded by a wrapped all_reduce,
stay within the pose-sized caps of tests/test_banded_dist.py:54-72,
tests/test_loop_dist.py:73 and tests/test_pcg_dist.py:91-115 (the one
(L, 4) gather of the final points excepted: the JAX solvers' per-device
outputs, which no all-reduce carries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_tricks_tpu.parallel import banded_dist as jbd
from slam_tricks_tpu.parallel import landmark_local as jll
from slam_tricks_tpu.parallel import loop_dist as jld
from slam_tricks_tpu.parallel import partition as jpart
from slam_tricks_tpu.parallel import pcg_dist as jpd
from slam_tricks_tpu.parallel import sharded_ba as jsb
from slam_tricks_tpu.residuals import robust as jrobust
from slam_tricks_tpu.sim import make_loop_scene as jmake_loop
from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.parallel import (banded_dist, landmark_local,
                                            loop_dist, partition, pcg_dist,
                                            sharded_ba)
from slam_tricks_tpu_torch.parallel.multihost import gather_owned
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.sim import make_loop_scene, make_trajectory_scene
from slam_tricks_tpu_torch.sim import BAObservations, perturb_scene
from slam_tricks_tpu_torch.solvers import banded_flat, schur_flat
from tests.torch_util import solve_cases, spawn_ranks

f64, f32 = torch.float64, torch.float32
PCG_KW = dict(max_iters=5, cg_iters=200, cg_tol=1e-12)


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(8), axis_names=("obs",))


def _port(jp0, jx0, jfx):
    return (interop.poses_from_jax(jp0, "cpu"), interop.tensor(jx0, "cpu"),
            interop.tensor(jfx, "cpu"))


def _outliers(obs, seed, share):
    """obs with one live observation in `share` moved by N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    uv = np.array(obs.uv)
    live = np.flatnonzero(np.asarray(obs.weight) > 0)
    hit = rng.choice(live, live.size // share, replace=False)
    uv[hit] += rng.normal(scale=0.3, size=(hit.size, 2))
    return obs._replace(uv=jnp.asarray(uv))


@pytest.fixture(scope="module")
def problems():
    """Each case's port arguments, the JAX distributed solver's state, and
    the trajectory's observations (the port's)."""
    mesh, cases, refs = _mesh(), {}, {}

    jsc = jmake_trajectory(n_cams=16, n_points=240, track_len=4, seed=73,
                           dtype=np.float64)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=74)
    p0, x0, fx = _port(jp0, jx0, jfx)
    obs = interop.obs_from_jax(jsc.obs, "cpu")
    refs["banded"] = jbd.make_ba_solver_banded_dist(mesh, max_iters=8)(
        jp0, jx0, jbd.build_dist_banded_work(jsc.obs, 16, 240, 8,
                                             dtype=np.float64), jfx)
    for D in (2, 3):
        cases[f"banded{D}"] = (
            banded_dist.make_ba_solver_banded_dist, dict(max_iters=8),
            (p0, x0, banded_dist.build_dist_banded_work(obs, 16, 240, D,
                                                        dtype=f64), fx))
    refs["pcg"] = jpd.make_ba_solver_pcg_dist(mesh, **PCG_KW)(
        jp0, jx0, jpd.build_dist_work(jpart.partition_obs_by_landmark(
            jsc.obs, 8), 16, 240, 8, dtype=np.float64), jfx)
    cases["pcg"] = (pcg_dist.make_ba_solver_pcg_dist, PCG_KW, (
        p0, x0, pcg_dist.build_dist_work(
            partition.partition_obs_by_landmark(obs, 2), 16, 240, 2,
            dtype=f64), fx))

    jsc = jmake_scene(n_per_wall=10, n_cams=6, seed=51, pix_noise=1e-3)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=52)
    jpo = jpart.partition_obs_by_landmark(jsc.obs, 8)
    jpairs = jpart.build_local_pairs(jpo, 8, dtype=np.float64)
    refs["sharded"] = jsb.make_ba_solver(mesh, max_iters=4)(
        jp0, jx0, jpo, jpairs, jfx)
    refs["lmlocal"] = jll.make_ba_solver_landmark_local(mesh, max_iters=4)(
        jp0, jx0, jpo, jpairs, jfx)
    po = partition.partition_obs_by_landmark(
        interop.obs_from_jax(jsc.obs, "cpu"), 2)
    args = (*_port(jp0, jx0, jfx)[:2], po,
            partition.build_local_pairs(po, 2, dtype=f64),
            interop.tensor(jfx, "cpu"))
    cases["sharded"] = (sharded_ba.make_ba_solver, dict(max_iters=4), args)
    cases["lmlocal"] = (landmark_local.make_ba_solver_landmark_local,
                        dict(max_iters=4), args)

    jsc = jmake_loop(n_cams=32, n_points=600, track_len=4, seed=97,
                     pix_noise=1e-3, dtype=np.float64)
    jp0, jx0, jfx = jperturb_scene(jsc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=98)
    refs["loop"] = jld.make_ba_solver_loop_dist(mesh, max_iters=6)(
        jp0, jx0, jld.build_dist_loop_work(jsc.obs, 32, 600, 8,
                                           dtype=np.float64, max_band=4),
        jfx)
    cases["loop"] = (loop_dist.make_ba_solver_loop_dist, dict(max_iters=6), (
        *_port(jp0, jx0, jfx)[:2], loop_dist.build_dist_loop_work(
            interop.obs_from_jax(jsc.obs, "cpu"), 32, 600, 2, dtype=f64,
            max_band=4), interop.tensor(jfx, "cpu")))

    jsc = jmake_trajectory(n_cams=32, n_points=600, track_len=4, seed=87,
                           dtype=np.float64)
    jp0, jx0, jfx = jperturb_scene(jsc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=88)
    jobs = _outliers(jsc.obs, 3, 50)
    refs["tukey"] = jbd.make_ba_solver_banded_dist(
        mesh, max_iters=8, loss=jrobust.tukey(0.02))(
        jp0, jx0, jbd.build_dist_banded_work(jobs, 32, 600, 8,
                                             dtype=np.float64), jfx)
    cases["tukey"] = (banded_dist.make_ba_solver_banded_dist,
                      dict(max_iters=8, loss=robust.tukey(0.02)), (
        *_port(jp0, jx0, jfx)[:2], banded_dist.build_dist_banded_work(
            interop.obs_from_jax(jobs, "cpu"), 32, 600, 2, dtype=f64),
        interop.tensor(jfx, "cpu")))
    return cases, refs, obs


def _count_cases():
    """The f32 problems of the JAX tests' collective bounds, 2 iterations
    (PCG: 10 CG iterations), with their caps in bytes."""
    out = []
    sc = make_trajectory_scene(n_cams=32, n_points=2000, track_len=5,
                               seed=83, dtype=f32, device="cpu")
    p0, x0, fx = perturb_scene(sc, seed=84)
    dw = banded_dist.build_dist_banded_work(sc.obs, 32, 2000, 2, dtype=f32)
    K = dw.local[0].w.shape[0]
    out.append(("count_banded", banded_dist.make_ba_solver_banded_dist,
                dict(max_iters=2), (p0, x0, dw, fx), K * 32 * 36 * 4 * 2,
                2000))
    sc = make_loop_scene(n_cams=32, n_points=600, track_len=4, seed=97,
                         pix_noise=1e-3, dtype=f32, device="cpu")
    p0, x0, fx = perturb_scene(sc, pose_rot_noise=0.002,
                               pose_trans_noise=0.01, point_noise=0.01,
                               seed=98)
    lw = loop_dist.build_dist_loop_work(sc.obs, 32, 600, 2, dtype=f32,
                                        max_band=4)
    K = lw.banded_local[0].w.shape[0]
    out.append(("count_loop", loop_dist.make_ba_solver_loop_dist,
                dict(max_iters=2), (p0, x0, lw, fx), K * 32 * 36 * 4 * 2,
                600))
    sc = make_trajectory_scene(n_cams=32, n_points=2000, track_len=5,
                               seed=65, dtype=f32, device="cpu")
    p0, x0, fx = perturb_scene(sc, seed=66)
    pw = pcg_dist.build_dist_work(partition.partition_obs_by_landmark(
        sc.obs, 2), 32, 2000, 2, dtype=f32)
    out.append(("count_pcg", pcg_dist.make_ba_solver_pcg_dist,
                dict(max_iters=2, cg_iters=10), (p0, x0, pw, fx),
                32 * 6 * 6 * 4 * 2, 2000))
    return out


def _single_rank_works(obs):
    """The trajectory's banded and PCG works split for one rank."""
    return {"banded2": banded_dist.build_dist_banded_work(obs, 16, 240, 1,
                                                          dtype=f64),
            "pcg": pcg_dist.build_dist_work(
                partition.partition_obs_by_landmark(obs, 1), 16, 240, 1,
                dtype=f64)}


@pytest.fixture(scope="module")
def ranks2(problems, tmp_path_factory):
    """Every D = 2 case on two gloo ranks; the banded and PCG cases also
    on a group of one rank (rank 0 alone) and the f32 cases with the
    all_reduce operands recorded. Returns (per-rank results, the count
    cases)."""
    cases, _, obs = problems
    jobs = [(key, make, kw, args, ()) for key, (make, kw, args)
            in cases.items() if key != "banded3"]
    for key, one in _single_rank_works(obs).items():
        make, kw, args = cases[key]
        jobs.append((f"{key}_self", make, kw,
                     (args[0], args[1], one, args[3]), ("self",)))
    counted = _count_cases()
    jobs += [(key, make, kw, args, ("count",))
             for key, make, kw, args, _, _ in counted]
    out = spawn_ranks(solve_cases, 2, tmp_path_factory.mktemp("ranks2"),
                      jobs, timeout=240.0)
    return out, counted


@pytest.fixture(scope="module")
def ranks3(problems, tmp_path_factory):
    """The banded case on three gloo ranks: an uneven split."""
    cases, _, _ = problems
    make, kw, args = cases["banded3"]
    return spawn_ranks(solve_cases, 3, tmp_path_factory.mktemp("ranks3"),
                       [("banded3", make, kw, args, ())], timeout=240.0)


def _compare(got, ref, cost_rtol=1e-7, pose_atol=1e-9, point_atol=1e-8):
    state, costs, _ = got
    assert state.it == int(ref.it), (state.it, int(ref.it))
    np.testing.assert_allclose(float(state.cost), float(ref.cost),
                               rtol=cost_rtol)
    np.testing.assert_allclose(state.poses.t.numpy(), np.asarray(ref.poses.t),
                               atol=pose_atol)
    np.testing.assert_allclose(state.poses.R.numpy(), np.asarray(ref.poses.R),
                               atol=pose_atol)
    if point_atol is not None:
        np.testing.assert_allclose(state.points.numpy(),
                                   np.asarray(ref.points), atol=point_atol)
    assert len(costs) == state.it + 1


@pytest.mark.parametrize("key", ["banded2", "pcg", "sharded", "lmlocal",
                                 "loop"])
def test_matches_jax_distributed_solver(problems, ranks2, key):
    _, refs, _ = problems
    _compare(ranks2[0][0][key], refs[key.rstrip("2")])


def test_banded_dist_uneven_split_matches_jax(problems, ranks3):
    _, refs, _ = problems
    for rank in range(3):
        _compare(ranks3[rank]["banded3"], refs["banded"])


def test_banded_dist_tukey_matches_jax(problems, ranks2):
    _, refs, _ = problems
    _compare(ranks2[0][0]["tukey"], refs["tukey"], cost_rtol=1e-6,
             pose_atol=1e-7, point_atol=None)


def test_ranks_agree_bitwise(ranks2, ranks3):
    out, _ = ranks2
    for results in (out, ranks3):
        for key, (state, costs, _) in results[0].items():
            for other in results[1:]:
                if key not in other:        # a group of rank 0 alone
                    continue
                o_state, o_costs, _ = other[key]
                assert o_state.it == state.it and o_costs == costs, key
                for a, b in ((state.poses.R, o_state.poses.R),
                             (state.poses.t, o_state.poses.t),
                             (state.points, o_state.points),
                             (state.cost, o_state.cost),
                             (state.lam, o_state.lam)):
                    assert torch.equal(a, b), key


def test_group_of_one_rank_is_the_single_process_solve(problems, ranks2):
    """A group of one rank runs the collectives on one process: the bits of
    the same solve with psum_axis=None, on that rank's work."""
    cases, _, obs = problems
    out, _ = ranks2
    p0, x0, _, fx = cases["banded2"][2]
    works = _single_rank_works(obs)
    bw = works["banded2"].local[0]
    final = banded_flat.solve_ba_banded(p0, x0, bw, fixed_mask=fx,
                                        max_iters=8)
    single = {"banded2": final}
    pw = works["pcg"]
    lm_global = pw.lm_global[0]
    final = schur_flat.solve_ba_flat(
        p0, x0[lm_global.clamp(0, 239)],
        BAObservations(pw.obs_cam[0], pw.obs_lm[0], pw.obs_uv[0],
                       pw.obs_w[0]), pw.flat[0], fixed_mask=fx,
        linear="pcg", pcg_work=pw.pcg[0], **PCG_KW)
    single["pcg"] = final._replace(points=gather_owned(
        x0, lm_global, final.points, None))
    for key, ref in single.items():
        state = out[0][f"{key}_self"][0]
        assert state.it == ref.it, key
        for a, b in ((state.poses.R, ref.poses.R),
                     (state.poses.t, ref.poses.t),
                     (state.points, ref.points), (state.cost, ref.cost)):
            assert torch.equal(a, b), key


@pytest.mark.parametrize("key", ["count_banded", "count_loop", "count_pcg"])
def test_all_reduce_operands_are_pose_sized(ranks2, key):
    out, counted = ranks2
    cap, n_points = next((c[4], c[5]) for c in counted if c[0] == key)
    calls = out[0][key][2]
    gathers = [c for c in calls if c[0] == 4 * n_points]
    assert len(gathers) == 1, gathers         # the final points, once
    sizes = [nbytes for numel, nbytes in calls if numel != 4 * n_points]
    assert len(sizes) >= 3, calls
    assert max(sizes) <= cap, (max(sizes), cap)
