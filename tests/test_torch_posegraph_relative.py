"""Path R, the relative-state pose-graph solver of the port
(slam_tricks_tpu_torch/solvers/posegraph.py::solve_pose_graph_relative),
against the JAX package's from the same numpy inputs:

- on the graph of tests/test_posegraph_chain.py::test_relative_parity_vs_dense
  (N = 60, 6 loops, seed 0), 30 iterations. f64: cost to rtol 1e-8,
  translations and rotations to 1e-6. The port stops after 19 iterations
  on an accepted step shorter than xtol at the f64 floor, where the JAX
  package rejects to its cap of 30 (a stop decision on sub-ulp differences
  of the cost), so the counts are not compared; the state is. f32: cost to
  rtol 1e-3 (the two f32 runs differ by f32 rounding through a QR and the
  capacitance solve);
- on bench.py:stage_posegraph's graph made in f32 (its seed and noise, N =
  2048 with 16 loops where the bench has 10,000 with 64), 80 iterations as
  the bench runs: cost to rtol 1e-3, ATE within 1%. The start integrates
  the f32 measurements, so its rotations are off orthonormal by what their
  rounding leaves; chip_smoke.py's path R makes that graph on the host, and
  it is held here to the JAX package's to within an ulp.

The JAX solves run under jax.jit, as bench.py runs them: each compiles
for ~10 s on the CPU, once a graph and dtype.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from slam_tricks_tpu.solvers import posegraph as jpg
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.solvers import posegraph as pg
from tests.test_posegraph_chain import make_graph
import tests.torch_util  # noqa: F401  (caps torch's threads)

_TDT = {np.float64: torch.float64, np.float32: torch.float32}
# bench.py:1220-1249, at the chain tests' N = 2048 and 16 loops
BENCH_F32 = dict(N=2048, n_loops=16, seed=17, odo_noise=0.002,
                 loop_noise=0.0005)


_jit_relative = jax.jit(jpg.solve_pose_graph_relative,
                        static_argnames=("max_iters",))


def _jax_relative(p0, jw, max_iters):
    """The JAX package's solve, finished before the port's starts: its
    threads would otherwise contend with torch's."""
    return jax.block_until_ready(_jit_relative(p0, jw, max_iters=max_iters))


def _ate(t, t_true):
    return float(np.sqrt(np.mean((np.asarray(t, np.float64) - t_true) ** 2)))


@pytest.fixture(scope="module")
def bench_f32():
    """The bench's graph as the JAX package makes it, in f32."""
    g = dict(BENCH_F32)
    N, L = g.pop("N"), g.pop("n_loops")
    return make_graph(N, L, dtype=np.float32, **g)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_relative_solve_matches_jax(dtype):
    N = 60
    pt, p0, ii, jj, Z, info = make_graph(N, 6, seed=0, dtype=dtype)
    jw = jpg.build_chain_work(ii, jj, Z, info, N, dtype=dtype)
    ref = _jax_relative(p0, jw, max_iters=30)
    costs = []
    out = pg.solve_pose_graph_relative(
        interop.poses_from_jax(p0, "cpu"),
        interop.chain_work_from_jax(jw, "cpu"), max_iters=30, costs=costs)
    assert out.poses.t.dtype == out.cost.dtype == _TDT[dtype]
    assert out.poses.t.shape == (N, 3)
    c = [float(x) for x in costs]
    assert all(b <= a for a, b in zip(c, c[1:])) and c[-1] < 1e-2 * c[0]
    if dtype == np.float64:
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=1e-8)
        for got, want in ((out.poses.t, ref.poses.t),
                          (out.poses.R, ref.poses.R)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=1e-3)


def _off_orthonormal(R):
    R = np.asarray(R, np.float64)
    return float(np.abs(np.swapaxes(R, -1, -2) @ R - np.eye(3)).max())


def test_chip_smoke_graph_is_the_bench_graph(bench_f32):
    """chip_smoke.circle_graph in f32 rounds the measurements' products as
    XLA does: the same Z to an ulp, the same start, and so the same drift
    of the start's rotations off orthonormal."""
    pt, p0, ii, jj, Z, info = bench_f32
    t_true, q0, i2, j2, Z2, info2 = chip_smoke.circle_graph(
        dtype=np.float32, device="cpu", **BENCH_F32)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ii))
    np.testing.assert_array_equal(j2.numpy(), np.asarray(jj))
    assert Z2.R.dtype == q0.R.dtype == info2.dtype == torch.float32
    np.testing.assert_array_equal(info2.numpy(), np.asarray(info))
    np.testing.assert_allclose(Z2.R.numpy(), np.asarray(Z.R), rtol=0,
                               atol=1.2e-7)
    np.testing.assert_allclose(Z2.t.numpy(), np.asarray(Z.t), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(q0.R.numpy(), np.asarray(p0.R), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(q0.t.numpy(), np.asarray(p0.t), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t_true.numpy(), np.asarray(pt.t), atol=1e-6)
    np.testing.assert_allclose(_off_orthonormal(q0.R),
                               _off_orthonormal(p0.R), rtol=0.1)


def test_relative_solve_matches_jax_on_f32_made_graph(bench_f32):
    pt, p0, ii, jj, Z, info = bench_f32
    N = BENCH_F32["N"]
    jw = jpg.build_chain_work(ii, jj, Z, info, N, dtype=np.float32)
    ref = _jax_relative(p0, jw, max_iters=80)
    costs = []
    out = pg.solve_pose_graph_relative(
        interop.poses_from_jax(p0, "cpu"),
        interop.chain_work_from_jax(jw, "cpu"), max_iters=80, costs=costs)
    assert out.poses.t.dtype == torch.float32
    c = [float(x) for x in costs]
    assert all(b <= a for a, b in zip(c, c[1:])) and c[-1] < 1e-4 * c[0]
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-3)
    t_true = np.asarray(pt.t, np.float64)
    ate, ate_ref = _ate(out.poses.t, t_true), _ate(ref.poses.t, t_true)
    assert abs(ate - ate_ref) < 0.01 * ate_ref
    assert ate < 0.25 * _ate(p0.t, t_true)
