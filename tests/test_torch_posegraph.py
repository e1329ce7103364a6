"""The SE(3) pose graphs of the port (slam_tricks_tpu_torch/sim/trajectory.py,
residuals/posegraph.py, solvers/posegraph.py) against the JAX package's, on
the same numpy inputs, in f64:

- make_pose_graph to 1e-12 (both draw one numpy sequence), also through
  interop.pose_graph_problem_from_jax; build_chain_work exactly, also
  through interop.chain_work_from_jax;
- the residuals and _edge_linearize's (r, Ji, Jj) at noiseless edges
  (r = 0) and noisy ones to 1e-10: the port's Jacobians are analytic
  (Jr^-1(r) and the adjoint), the JAX package's come from jax.jacfwd;
- _compose_chain on 1000 increments to 1e-12;
- path Q, solve_pose_graph on make_pose_graph(n=40, odo_noise=0.03,
  meas_noise=0.003, seed=2): 4 iterations, before the f64 floor, with the
  same count, cost to rtol 1e-9 and poses to 1e-8; and 50, the cost and
  poses to the same tolerances. At the floor (cost ~7.5e-5, moving by
  ulps) the port accepts a step shorter than xtol and stops after 7 where
  the JAX package rejects to its cap of 50: a stop decision on sub-ulp
  differences of the cost, as at the BA solvers' floor (ROADMAP.md, known
  properties), so the counts are compared before it;
- path T, solve_pose_graph_chain at N = 60 with 6 loops (the graph of
  tests/test_posegraph_chain.py::test_parity_vs_dense, 8 iterations): the
  same count, cost rtol 1e-8, translations 1e-6 (that test's tolerances);
- the chain solver's f32 input at N = 385 is solved in f64 and returned
  in f32 (port only: the JAX package does so only with x64 on).

Each JAX solve compiles once a module (a fixture); the JAX loops take
most of this file's time.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.residuals import posegraph as jres
from slam_tricks_tpu.sim.trajectory import make_pose_graph as jmake_pose_graph
from slam_tricks_tpu.solvers import posegraph as jpg
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.residuals import posegraph as res
from slam_tricks_tpu_torch.sim import make_pose_graph
from slam_tricks_tpu_torch.solvers import posegraph as pg
from tests.test_posegraph_chain import make_graph
from tests.torch_util import default_threads

_REPO = Path(__file__).resolve().parents[1]
_Q = dict(n=40, odo_noise=0.03, meas_noise=0.003, seed=2)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def graph_q():
    jprob = jmake_pose_graph(**_Q)
    return jprob, interop.pose_graph_problem_from_jax(jprob, device="cpu")


@pytest.fixture(scope="module")
def solves_q(graph_q):
    """JAX's dense solve at 4 and 50 iterations, from one compile (the cap
    is traced)."""
    jprob, _ = graph_q
    solve = jax.jit(lambda mi: jpg.solve_pose_graph(
        jprob.poses_init, jprob.i_idx, jprob.j_idx, jprob.Z,
        fixed_mask=jprob.fixed_mask, max_iters=mi))
    return {n: jax.block_until_ready(solve(n)) for n in (4, 50)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_make_pose_graph_matches_jax(dtype, graph_q):
    tdt = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    tol = 1e-12 if dtype == np.float64 else 1e-5
    jprob = (graph_q[0] if dtype == np.float64
             else jmake_pose_graph(dtype=dtype, **_Q))
    prob = make_pose_graph(dtype=tdt, device="cpu", **_Q)
    for name in ("poses_true", "poses_init", "Z"):
        got, want = getattr(prob, name), getattr(jprob, name)
        assert got.R.dtype == tdt
        _close(got.R, want.R, tol)
        _close(got.t, want.t, tol)
    assert np.array_equal(_np(prob.i_idx), _np(jprob.i_idx))
    assert np.array_equal(_np(prob.j_idx), _np(jprob.j_idx))
    assert np.array_equal(_np(prob.fixed_mask), _np(jprob.fixed_mask))
    if dtype == np.float64:     # the converter gives the same graph
        conv = graph_q[1]
        for name in ("poses_true", "poses_init", "Z"):
            _close(getattr(conv, name).t, getattr(prob, name).t, 1e-12)
        assert conv.i_idx.dtype == torch.int64
        assert torch.equal(conv.j_idx, prob.j_idx)


def _edges(kind, jprob):
    """(poses, i, j, Z, sqrt_info) of Q's graph, its own measurements
    (noisy) or those of the truth (r = 0 at the truth)."""
    if kind == "noiseless":
        T = jprob.poses_true
        Ti = jax.tree_util.tree_map(lambda a: a[jprob.i_idx], T)
        Tj = jax.tree_util.tree_map(lambda a: a[jprob.j_idx], T)
        Z = jax.vmap(lambda a, b: jse3.mul(jse3.inv(a), b))(Ti, Tj)
        poses = T
    else:
        Z, poses = jprob.Z, jprob.poses_init
    E = jprob.i_idx.shape[0]
    L = np.broadcast_to(np.eye(6), (E, 6, 6)) * (1.0 + np.arange(E))[
        :, None, None] ** 0.5
    return poses, jprob.i_idx, jprob.j_idx, Z, jnp.asarray(L)


@pytest.mark.parametrize("kind", ["noiseless", "noisy"])
def test_residuals_and_edge_linearize_match_jax(kind, graph_q):
    poses, ii, jj, Z, L = _edges(kind, graph_q[0])
    tp, tZ = interop.poses_from_jax(poses, "cpu"), interop.poses_from_jax(
        Z, "cpu")
    ti, tj, tL = (interop.tensor(a, "cpu") for a in (ii, jj, L))
    Ti = jax.tree_util.tree_map(lambda a: a[ii], poses)
    Tj = jax.tree_util.tree_map(lambda a: a[jj], poses)
    tTi = se3.SE3(tp.R[ti], tp.t[ti])
    tTj = se3.SE3(tp.R[tj], tp.t[tj])
    _close(res.relative_se3_residual(tTi, tTj, tZ),
           jax.vmap(jres.relative_se3_residual)(Ti, Tj, Z), 1e-10)
    _close(res.relative_se3_residual_weighted(tTi, tTj, tZ, tL),
           jax.vmap(jres.relative_se3_residual_weighted)(Ti, Tj, Z, L), 1e-10)
    r, Ji, Jj = pg._edge_linearize(tp, ti, tj, tZ, tL)
    jr, jJi, jJj = jax.jit(jpg._edge_linearize)(poses, ii, jj, Z, L)
    if kind == "noiseless":
        assert float(np.abs(np.asarray(jr)).max()) < 1e-12
    for got, want in ((r, jr), (Ji, jJi), (Jj, jJj)):
        assert torch.isfinite(got).all()
        _close(got, want, 1e-10)
    _close(pg._pg_cost(tp, ti, tj, tZ, tL),
           jpg._pg_cost(poses, ii, jj, Z, L), 1e-12, 1e-12)


def test_build_chain_work_matches_jax():
    _, _, ii, jj, Z, info = make_graph(30, 5, seed=4)
    jw = jpg.build_chain_work(ii, jj, Z, info, 30, dtype=np.float64)
    w = pg.build_chain_work(interop.tensor(ii, "cpu"),
                            interop.tensor(jj, "cpu"),
                            interop.poses_from_jax(Z, "cpu"),
                            interop.tensor(info, "cpu"), 30,
                            dtype=torch.float64, device="cpu")
    conv = interop.chain_work_from_jax(jw, "cpu")
    assert w.loop_i.shape == (8,) and w.loop_i.dtype == torch.int64
    for got in (w, conv):
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(jw)):
            assert np.array_equal(_np(a), np.asarray(b))


def test_compose_chain_matches_jax():
    rng = np.random.default_rng(5)
    xi = 0.05 * rng.normal(size=(1000, 6))
    xi[:, :3] *= 20.0
    m_j = jax.vmap(jse3.exp)(jnp.asarray(xi))
    T0_j = jse3.exp(jnp.asarray(rng.normal(size=6)))
    want = jax.jit(jpg._compose_chain)(T0_j, m_j)
    got = pg._compose_chain(interop.poses_from_jax(T0_j, "cpu"),
                            interop.poses_from_jax(m_j, "cpu"))
    assert got.R.shape == (1001, 3, 3)
    _close(got.R, want.R, 1e-12)
    _close(got.t, want.t, 1e-12)


@pytest.mark.parametrize("iters", [4, 50])
def test_dense_solve_matches_jax(iters, graph_q, solves_q):
    _, prob = graph_q
    ref = solves_q[iters]
    with default_threads():     # the floor's stop decision: see torch_util
        out = pg.solve_pose_graph(prob.poses_init, prob.i_idx, prob.j_idx,
                                  prob.Z, fixed_mask=prob.fixed_mask,
                                  max_iters=iters)
    if iters == 4:
        assert out.it == int(ref.it) == 4 and not out.done
    else:       # the stop at the floor: see the module docstring
        assert out.done and 4 < out.it <= int(ref.it)
    _close(out.cost, ref.cost, 0.0, 1e-9)
    _close(out.poses.t, ref.poses.t, 1e-8)
    _close(out.poses.R, ref.poses.R, 1e-8)


def test_chain_solve_matches_jax():
    N = 60
    _, p0, ii, jj, Z, info = make_graph(N, 6, seed=3)
    jw = jpg.build_chain_work(ii, jj, Z, info, N, dtype=np.float64)
    ref = jax.block_until_ready(
        jpg.solve_pose_graph_chain(p0, jw, max_iters=8))
    out = pg.solve_pose_graph_chain(interop.poses_from_jax(p0, "cpu"),
                                    interop.chain_work_from_jax(jw, "cpu"),
                                    max_iters=8)
    assert out.it == int(ref.it)
    _close(out.cost, ref.cost, 0.0, 1e-8)
    _close(out.poses.t, ref.poses.t, 1e-6)


def test_chain_solver_upcasts_f32_above_384():
    """f32 input at N = 385 runs in f64 and comes back in f32: the same
    numbers as the f64 solve of the same input, cast."""
    N = 385
    _, p0, ii, jj, Z, info = make_graph(N, 4, seed=6, dtype=np.float32)
    p32 = interop.poses_from_jax(p0, "cpu")
    w32 = pg.build_chain_work(interop.tensor(ii, "cpu"),
                              interop.tensor(jj, "cpu"),
                              interop.poses_from_jax(Z, "cpu"),
                              interop.tensor(info, "cpu"), N,
                              dtype=torch.float32, device="cpu")
    costs = []
    out = pg.solve_pose_graph_chain(p32, w32, max_iters=2, costs=costs)
    ref = pg.solve_pose_graph_chain(pg._cast(p32, torch.float64),
                                    pg._cast(w32, torch.float64), max_iters=2)
    assert out.poses.t.dtype == out.cost.dtype == torch.float32
    assert all(c.dtype == torch.float32 for c in costs)
    assert out.it == ref.it == 2
    assert torch.equal(out.poses.t, ref.poses.t.float())
    assert float(out.cost) == float(ref.cost.float())
    assert float(costs[-1]) < float(costs[0])


def test_import_leaves_jax_out():
    code = ("import sys, slam_tricks_tpu_torch.manifolds, "
            "slam_tricks_tpu_torch.sim.trajectory, "
            "slam_tricks_tpu_torch.residuals.posegraph, "
            "slam_tricks_tpu_torch.solvers.posegraph, "
            "slam_tricks_tpu_torch.solvers.posegraph_sim3, "
            "slam_tricks_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'slam_tricks_tpu']; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
