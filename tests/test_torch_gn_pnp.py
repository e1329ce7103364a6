"""The port's generic Gauss-Newton (slam_tricks_tpu_torch/solvers/gn.py)
and batched PnP (solvers/pnp.py) against the JAX package's, on the same
seeded numpy inputs, in f64:

- gauss_newton on the problems of tests/test_dense_solvers.py: PnP on
  lie(se3) and so3_r3 (noiseless and with noise 1e-3), SE(3) ICP with
  known correspondences, the golden SE(2) ICP, and a weighted PnP: the
  same iteration count and stop flag, x to 1e-10 and the cost to rtol
  1e-8 (atol 1e-20 at the noiseless floor);
- gauss_newton_batched on 8 PnP problems (the JAX package's vmap of
  gauss_newton): the same per-problem counts, x to 1e-10, costs as above;
  an n = 20 problem (euclidean(20)) through spd_solve's plain version, one
  call a problem;
- solve_pnp on one problem and solve_pnp_batched on 16 (the JAX
  package's test_pnp_specialized problems), with noise 1e-3: the same
  counts, T to 1e-10, costs to rtol 1e-8; weights;
- common.solve_damped_normal batched (n = 6 and n = 20) against one call
  a problem: 1e-14; a non-SPD problem in the batch gives a zero step and
  bad for that problem only.

Each JAX reference runs under jax.jit and is waited for before the port
runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.manifolds import euclidean as jeuclid
from slam_tricks_tpu.manifolds import lie as jlie
from slam_tricks_tpu.manifolds import se2 as jse2
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu.manifolds import so3_r3 as jso3_r3
from slam_tricks_tpu.residuals import icp as jicp
from slam_tricks_tpu.residuals import reprojection as jrep
from slam_tricks_tpu.solvers import gauss_newton as jgn
from slam_tricks_tpu.solvers.pnp import solve_pnp as jsolve_pnp
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.manifolds import (euclidean, lie, se2, se3,
                                             so3_r3)
from slam_tricks_tpu_torch.residuals import icp, reprojection
from slam_tricks_tpu_torch.solvers import common
from slam_tricks_tpu_torch.solvers.gn import (gauss_newton,
                                              gauss_newton_batched)
from slam_tricks_tpu_torch.solvers.pnp import solve_pnp, solve_pnp_batched
import tests.torch_util  # noqa: F401  (caps torch's threads)


def T(a):
    return torch.as_tensor(np.array(a))


def make_pnp_problem(n=20, noise=0.0, seed=0):
    """tests/test_dense_solvers.py's PnP problem: (T_true, pts, uv) numpy,
    and a start T0 0.1 away in the tangent."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], size=(n, 3))
    T_true = jse3.exp(jnp.asarray(rng.normal(size=6) * 0.3))
    p_cam = np.asarray(jse3.act(T_true, jnp.asarray(pts)))
    uv = p_cam[:, :2] / p_cam[:, 2:] + rng.normal(size=(n, 2)) * noise
    T0 = jse3.retract(T_true, jnp.asarray(rng.normal(size=6) * 0.1))
    return T0, pts, uv


def jpnp_residual(Tc, pts, uv):
    return jax.vmap(lambda p, o: jrep.reproject_normalized(Tc, p, o))(pts, uv)


def pnp_residual(Tc, pts, uv):
    return reprojection.reproject_normalized(Tc, pts, uv)


def check_result(res, ref, x_err, floor=1e-20):
    assert np.array_equal(np.asarray(res.iterations),
                          np.asarray(ref.iterations))
    assert np.array_equal(np.asarray(res.converged), np.asarray(ref.converged))
    assert x_err < 1e-10, x_err
    np.testing.assert_allclose(np.asarray(res.cost), np.asarray(ref.cost),
                               rtol=1e-8, atol=floor)


@pytest.mark.parametrize("manifold, noise, iters", [
    ("se3", 0.0, 15), ("se3", 1e-3, 15), ("so3_r3", 1e-3, 15),
    ("se3", 1e-3, 2)])
def test_gauss_newton_pnp_matches_jax(manifold, noise, iters):
    T0, pts, uv = make_pnp_problem(noise=noise, seed=1)
    jm, m = ((jlie(jse3), lie(se3)) if manifold == "se3"
             else (jso3_r3(), so3_r3()))
    ref = jax.block_until_ready(jax.jit(lambda x, p, o: jgn(
        jpnp_residual, x, jm, args=(p, o), iters=iters))(
            T0, jnp.asarray(pts), jnp.asarray(uv)))
    res = gauss_newton(pnp_residual, interop.poses_from_jax(T0, "cpu"), m,
                       args=(T(pts), T(uv)), iters=iters)
    err = max(float((res.x.R - T(ref.x.R)).abs().max()),
              float((res.x.t - T(ref.x.t)).abs().max()))
    check_result(res, ref, err)
    assert res.iterations.dtype == torch.int32 and res.cost.shape == ()
    if noise == 0.0:
        assert float(res.cost) < 1e-16


def test_gauss_newton_weighted_pnp():
    T0, pts, uv = make_pnp_problem(noise=1e-3, seed=2)
    w = np.random.default_rng(3).uniform(0.5, 2.0, size=40)
    ref = jax.block_until_ready(jax.jit(lambda x, p, o: jgn(
        jpnp_residual, x, jlie(jse3), args=(p, o), iters=10,
        weights=jnp.asarray(w)))(T0, jnp.asarray(pts), jnp.asarray(uv)))
    res = gauss_newton(pnp_residual, interop.poses_from_jax(T0, "cpu"),
                       lie(se3), args=(T(pts), T(uv)), iters=10,
                       weights=T(w))
    err = max(float((res.x.R - T(ref.x.R)).abs().max()),
              float((res.x.t - T(ref.x.t)).abs().max()))
    check_result(res, ref, err)


def test_gauss_newton_icp_se3_and_se2_match_jax():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(100, 3))
    jT = jse3.exp(jnp.asarray([0.2, -0.1, 0.3, 0.4, 0.2, -0.5]))
    dst = np.asarray(jse3.act(jT, jnp.asarray(src)))

    def jres3(Tc, s, d):
        return jax.vmap(lambda a, b: jicp.point_residual_se3(Tc, a, b))(s, d)

    ref = jax.block_until_ready(jax.jit(lambda s, d: jgn(
        jres3, jse3.identity(jnp.float64), jlie(jse3), args=(s, d),
        iters=10))(jnp.asarray(src), jnp.asarray(dst)))
    res = gauss_newton(icp.point_residual_se3,
                       se3.identity(torch.float64, "cpu"), lie(se3),
                       args=(T(src), T(dst)), iters=10)
    err = max(float((res.x.R - T(ref.x.R)).abs().max()),
              float((res.x.t - T(ref.x.t)).abs().max()))
    check_result(res, ref, err)
    assert float((res.x.t - T(jT.t)).abs().max()) < 1e-9

    pts = rng.uniform(-3, 3, size=(50, 2))
    jT2 = jse2.SE2(jnp.asarray(np.pi / 4), jnp.asarray([2.0, 2.0]))
    dst2 = np.asarray(jse2.act(jT2, jnp.asarray(pts)))

    def jres2(Tc, s, d):
        return jax.vmap(lambda a, b: jicp.point_residual_se2(Tc, a, b))(s, d)

    ref = jax.block_until_ready(jax.jit(lambda s, d: jgn(
        jres2, jse2.identity(jnp.float64), jlie(jse2), args=(s, d),
        iters=10))(jnp.asarray(pts), jnp.asarray(dst2)))
    res = gauss_newton(icp.point_residual_se2,
                       se2.identity(torch.float64, "cpu"), lie(se2),
                       args=(T(pts), T(dst2)), iters=10)
    err = max(abs(float(res.x.theta) - float(ref.x.theta)),
              float((res.x.t - T(ref.x.t)).abs().max()))
    check_result(res, ref, err)
    assert abs(float(res.x.theta) - np.pi / 4) < 1e-10


def test_gauss_newton_batched_matches_jax_vmap():
    probs = [make_pnp_problem(noise=1e-3 * (i % 2), seed=10 + i)
             for i in range(8)]
    jT0 = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[p[0] for p in
                                                             probs])
    pts = np.stack([p[1] for p in probs])
    uv = np.stack([p[2] for p in probs])
    ref = jax.block_until_ready(jax.jit(jax.vmap(lambda x, p, o: jgn(
        jpnp_residual, x, jlie(jse3), args=(p, o), iters=15)))(
            jT0, jnp.asarray(pts), jnp.asarray(uv)))
    res = gauss_newton_batched(pnp_residual,
                               interop.poses_from_jax(jT0, "cpu"), lie(se3),
                               (T(pts), T(uv)), iters=15)
    assert res.cost.shape == (8,)
    err = max(float((res.x.R - T(ref.x.R)).abs().max()),
              float((res.x.t - T(ref.x.t)).abs().max()))
    check_result(res, ref, err)


def test_gauss_newton_batched_large_n_through_spd_solve(monkeypatch):
    """n = 20 unknowns a problem: one spd_solve call a problem a step."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(3, 30, 20))
    b = rng.normal(size=(3, 30))

    def jres(x, a, y):
        return a @ x + 0.1 * jnp.sin(x[:30 - 10]).sum() - y

    def res_fn(x, a, y):
        return a @ x + 0.1 * torch.sin(x[:30 - 10]).sum() - y

    ref = jax.block_until_ready(jax.jit(jax.vmap(lambda a, y: jgn(
        jres, jnp.zeros(20), jeuclid(20), args=(a, y), iters=6)))(
            jnp.asarray(A), jnp.asarray(b)))
    calls = []
    real = common.spd_solve
    monkeypatch.setattr(common, "spd_solve",
                        lambda S, r: calls.append(S.shape) or real(S, r))
    res = gauss_newton_batched(res_fn, torch.zeros(3, 20, dtype=torch.float64),
                               euclidean(20), (T(A), T(b)), iters=6)
    assert calls and len(calls) == 3 * 6 and set(calls) == {(20, 20)}
    check_result(res, ref, float((res.x - T(ref.x)).abs().max()))


def test_gauss_newton_passes_non_tensor_args_as_they_are():
    """A Python number in args reaches the residual untouched, as the JAX
    package's gauss_newton hands it over (it used to be batched as a tensor
    and raise TypeError); in a batch it is shared by every problem. f64, x
    to 1e-12."""
    ref = jgn(lambda x, a: x - a, jnp.zeros(3), jeuclid(3), args=(1.5,))
    res = gauss_newton(lambda x, a: x - a, torch.zeros(3, dtype=torch.float64),
                       euclidean(3), args=(1.5,))
    assert float((res.x - T(ref.x)).abs().max()) < 1e-12
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(res.x.numpy(), [1.5, 1.5, 1.5], atol=1e-12)
    shift = np.arange(4.0)[:, None] * np.ones((4, 3))
    jref = jax.vmap(lambda s: jgn(lambda x, a, b: x - a * b, jnp.zeros(3),
                                  jeuclid(3), args=(s, 2.0)).x)(
        jnp.asarray(shift))
    resb = gauss_newton_batched(lambda x, a, b: x - a * b,
                                torch.zeros(4, 3, dtype=torch.float64),
                                euclidean(3), (T(shift), 2.0))
    assert float((resb.x - T(jref)).abs().max()) < 1e-12


def make_pnp_specialized(seed, n=24, noise=1e-3):
    """tests/test_pnp_specialized.py's make_problem, with noise."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3))
    T_true = jse3.exp(jnp.asarray(rng.normal(size=6) * 0.3))
    pc = np.asarray(jse3.act(T_true, jnp.asarray(pts)))
    uv = pc[:, :2] / pc[:, 2:] + rng.normal(size=(n, 2)) * noise
    T0 = jse3.retract(T_true, jnp.asarray(rng.normal(size=6) * 0.1))
    return T0, pts, uv


def test_solve_pnp_matches_jax():
    T0, pts, uv = make_pnp_specialized(0)
    w = np.random.default_rng(1).uniform(0.5, 2.0, size=24)
    for weights in (None, w):
        ref = jax.block_until_ready(jax.jit(lambda x, p, o: jsolve_pnp(
            x, p, o, iters=12,
            weights=None if weights is None else jnp.asarray(weights)))(
                T0, jnp.asarray(pts), jnp.asarray(uv)))
        res = solve_pnp(interop.poses_from_jax(T0, "cpu"), T(pts), T(uv),
                        iters=12, weights=None if weights is None
                        else T(weights))
        assert int(res.iterations) == int(ref.iterations)
        assert float((res.T.R - T(ref.T.R)).abs().max()) < 1e-10
        assert float((res.T.t - T(ref.T.t)).abs().max()) < 1e-10
        np.testing.assert_allclose(float(res.cost), float(ref.cost),
                                   rtol=1e-8)


def test_solve_pnp_batched_matches_jax():
    probs = [make_pnp_specialized(i, noise=1e-3 * (i % 3 == 0))
             for i in range(16)]
    jT0 = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[p[0] for p in
                                                             probs])
    pts = np.stack([p[1] for p in probs])
    uv = np.stack([p[2] for p in probs])
    ref = jax.block_until_ready(jax.jit(jax.vmap(
        lambda x, p, o: jsolve_pnp(x, p, o)))(jT0, jnp.asarray(pts),
                                              jnp.asarray(uv)))
    res = solve_pnp_batched(interop.poses_from_jax(jT0, "cpu"), T(pts),
                            T(uv))
    assert np.array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    assert float((res.T.R - T(ref.T.R)).abs().max()) < 1e-10
    assert float((res.T.t - T(ref.T.t)).abs().max()) < 1e-10
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-8, atol=1e-20)
    clean = [i for i in range(16) if i % 3]
    assert float(res.cost[clean].max()) < 1e-18


@pytest.mark.parametrize("n", [6, 20])
def test_solve_damped_normal_batched(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(4, n + 3, n))
    H = T(np.einsum("bki,bkj->bij", A, A))
    g = T(rng.normal(size=(4, n)))
    H[2, 0, 0] = -1.0                      # not positive definite
    lam = torch.tensor(1e-3, dtype=torch.float64)
    delta, bad = common.solve_damped_normal(H, g, lam)
    assert bad.tolist() == [False, False, True, False]
    for i in range(4):
        d1, b1 = common.solve_damped_normal(H[i], g[i], lam)
        assert bool(b1) == bool(bad[i]) and b1.shape == ()
        assert float((delta[i] - d1).abs().max()) <= 1e-14 * max(
            float(d1.abs().max()), 1.0)
    assert float(delta[2].abs().max()) == 0.0
