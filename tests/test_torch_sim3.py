"""Path S, the Sim(3) pose graph of the port
(slam_tricks_tpu_torch/solvers/posegraph_sim3.py, residuals/posegraph.py's
Sim(3) factor), against the JAX package's on the same numpy inputs:

- relative_sim3_residual and _edge_linearize's (r, Ji, Jj) at noiseless
  edges (r = 0) and noisy ones, f64, to 1e-10 (the port's Jacobians are
  analytic, Jr^-1(r) = phi1(-ad r)^-1 and the adjoint; the JAX package's
  come from jax.jacfwd);
- solve_pose_graph_sim3 on tests/test_sim3.py's _mono_loop_graph(N=32,
  n_loops=4), 50 iterations: f64 the same count, cost to rtol 1e-8 and the
  scales to 1e-8; f32 the cost to rtol 1e-3. Both reach the JAX test's
  gates (scale error, ATE against the start).

Each JAX solve compiles once a dtype (~8 s on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.residuals import posegraph as jres
from slam_tricks_tpu.solvers import posegraph_sim3 as jps
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.residuals import posegraph as res
from slam_tricks_tpu_torch.solvers import posegraph_sim3 as ps
from tests.test_sim3 import _mono_loop_graph
from tests.torch_util import default_threads

_TDT = {np.float64: torch.float64, np.float32: torch.float32}


def _ate(t, t_true):
    t = t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return float(np.sqrt(np.mean(np.sum((t - t_true) ** 2, 1))))


@pytest.mark.parametrize("kind", ["noiseless", "noisy"])
def test_sim3_residual_and_edge_linearize_match_jax(kind):
    """Noiseless: the poses on the truth, whose loop measurements are exact
    (r = 0 on every loop edge) and odometry noisy; noisy: the drifted
    start, where the residuals reach the drift's size."""
    t_true, p, poses0, ii, jj, Z, info = _mono_loop_graph(N=32, n_loops=4)
    if kind == "noiseless":
        ang = 2 * np.pi * np.arange(32) / 32
        R = jnp.asarray(np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                                            [np.sin(a), np.cos(a), 0],
                                            [0, 0, 1]]) for a in ang]))
        poses0 = poses0._replace(R=R, t=jnp.asarray(t_true),
                                 s=jnp.asarray(p))
    tp, tZ = (interop.sim3_from_jax(x, "cpu") for x in (poses0, Z))
    ti, tj, tL = (interop.tensor(a, "cpu") for a in (ii, jj, info))
    Si = jax.tree_util.tree_map(lambda a: a[ii], poses0)
    Sj = jax.tree_util.tree_map(lambda a: a[jj], poses0)
    tSi = type(tp)(*(a[ti] for a in tp))
    tSj = type(tp)(*(a[tj] for a in tp))
    r_raw = res.relative_sim3_residual(tSi, tSj, tZ)
    np.testing.assert_allclose(
        r_raw.numpy(), np.asarray(jax.vmap(jres.relative_sim3_residual)(
            Si, Sj, Z)), rtol=0, atol=1e-10)
    r, Ji, Jj = ps._edge_linearize(tp, ti, tj, tZ, tL)
    jr, jJi, jJj = jax.jit(jps._edge_linearize)(poses0, ii, jj, Z, info)
    if kind == "noiseless":
        assert float(np.abs(np.asarray(jr)[31:]).max()) < 1e-12
    for got, want in ((r, jr), (Ji, jJi), (Jj, jJj)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sim3_solve_matches_jax(dtype):
    t_true, p, poses0, ii, jj, Z, info = _mono_loop_graph(N=32, n_loops=4,
                                                          dtype=dtype)
    ref = jax.block_until_ready(
        jps.solve_pose_graph_sim3(poses0, ii, jj, Z, info, max_iters=50))
    costs = []
    with default_threads():     # the floor's stop decision: see torch_util
        out = ps.solve_pose_graph_sim3(
            interop.sim3_from_jax(poses0, "cpu"), interop.tensor(ii, "cpu"),
            interop.tensor(jj, "cpu"), interop.sim3_from_jax(Z, "cpu"),
            interop.tensor(info, "cpu"), max_iters=50, costs=costs)
    assert out.poses.s.dtype == out.cost.dtype == _TDT[dtype]
    c = [float(x) for x in costs]
    assert all(b <= a for a, b in zip(c, c[1:]))
    s_err = float(np.abs(out.poses.s.double().numpy() / p - 1.0).max())
    ate0, ate = _ate(np.asarray(poses0.t), t_true), _ate(out.poses.t, t_true)
    if dtype == np.float64:
        assert out.it == int(ref.it)
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=1e-8)
        np.testing.assert_allclose(out.poses.s.numpy(),
                                   np.asarray(ref.poses.s), rtol=0, atol=1e-8)
        assert ate < 0.1 * ate0 and s_err < 0.02
    else:
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=1e-3)
        assert ate < 0.2 * ate0 and s_err < 0.06
