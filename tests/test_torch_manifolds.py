"""The port's SO(3)/SE(3) (slam_tricks_tpu_torch/manifolds) against the JAX
package's, on the same numpy tangents: random angles, theta^2 < 1e-8 (the
Taylor branch of every coefficient) and theta^2 on both sides of the f32
cancellation switch 4e-2.

Tolerances: f64 to 1e-12 (both sides evaluate the same closed forms and
Taylor series; only summation order differs), f32 to 1e-6 (a few f32 ulps
of O(1) entries).

Then every other function of so3 / se3 / so2 / se2 / sim3 and the
manifold combinators (manifold.py; batched over 8 copies, with the round
trip local(x, retract(x, d)) = d), against the JAX package on the same
numpy inputs: f64 to 1e-12 (logs and what goes through a log or a small
solve: 1e-10), f32 to 1e-5; sim3.from_matrix's negative scale of a
reflection, copied from the JAX package; and the random draws (a
torch.Generator in place of a JAX key) are group elements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.manifolds import manifold as jmanifold
from slam_tricks_tpu.manifolds import se2 as jse2
from slam_tricks_tpu.manifolds import se3 as jse3
from slam_tricks_tpu.manifolds import sim3 as jsim3
from slam_tricks_tpu.manifolds import so2 as jso2
from slam_tricks_tpu.manifolds import so3 as jso3
from slam_tricks_tpu_torch.manifolds import manifold, se2, se3, sim3, so2, so3
import tests.torch_util  # noqa: F401  (caps torch's threads)

_TOL = {np.float64: 1e-12, np.float32: 1e-6}
_TDT = {np.float64: torch.float64, np.float32: torch.float32}


def _tangents(kind, n=64, seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    if kind == "random":
        theta = rng.uniform(0.0, 3.0, size=n)
    elif kind == "tiny":                       # theta^2 < 1e-8
        theta = 10.0 ** rng.uniform(-9, -4.2, size=n)
    else:                                      # theta^2 around 4e-2
        theta = np.sqrt(4e-2 * (1.0 + rng.uniform(-1e-3, 1e-3, size=n)))
    return dirs * theta[:, None]


def _close(a_t, b_j, dtype):
    np.testing.assert_allclose(a_t.numpy(), np.asarray(b_j), rtol=0,
                               atol=_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["random", "tiny", "f32_switch"])
def test_so3_matches_jax(kind, dtype):
    w = _tangents(kind).astype(dtype)
    w_t = torch.as_tensor(w)
    R_t = so3.exp(w_t)
    R_j = jax.vmap(jso3.exp)(jnp.asarray(w))
    _close(R_t, R_j, dtype)
    _close(so3.jl(w_t), jax.vmap(jso3.jl)(jnp.asarray(w)), dtype)
    _close(so3.jl_inv(w_t), jax.vmap(jso3.jl_inv)(jnp.asarray(w)), dtype)
    _close(so3.log(R_t), jax.vmap(jso3.log)(jnp.asarray(R_t.numpy())), dtype)
    d = (_tangents("random", seed=1) * 0.3).astype(dtype)
    _close(so3.retract(R_t, torch.as_tensor(d)),
           jax.vmap(jso3.retract)(jnp.asarray(R_t.numpy()), jnp.asarray(d)),
           dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["random", "tiny", "f32_switch"])
def test_se3_retract_matches_jax(kind, dtype):
    rng = np.random.default_rng(2)
    n = 64
    R0 = so3.exp(torch.as_tensor(_tangents("random", n, seed=3))).numpy()
    t0 = rng.normal(size=(n, 3))
    xi = np.concatenate([rng.normal(size=(n, 3)), _tangents(kind, n)], axis=1)
    R0, t0, xi = R0.astype(dtype), t0.astype(dtype), xi.astype(dtype)
    out = se3.retract(se3.SE3(torch.as_tensor(R0), torch.as_tensor(t0)),
                      torch.as_tensor(xi))
    ref = jax.vmap(jse3.retract)(jse3.SE3(jnp.asarray(R0), jnp.asarray(t0)),
                                 jnp.asarray(xi))
    assert out.R.dtype == _TDT[dtype]
    _close(out.R, ref.R, dtype)
    _close(out.t, ref.t, dtype)


# ---- the rest of the groups (pose graphs and Sim(3)) ----

_GTOL = {np.float64: 1e-12, np.float32: 1e-5}
_LTOL = {np.float64: 1e-10, np.float32: 1e-5}


def _check(a_t, b_j, dtype, tol=_GTOL):
    a = (a_t.numpy() if isinstance(a_t, torch.Tensor)
         else np.asarray(a_t))
    assert a.dtype == np.dtype(dtype)
    np.testing.assert_allclose(a, np.asarray(b_j), rtol=0, atol=tol[dtype])


def _rotations(n, seed, dtype):
    R = so3.exp(torch.as_tensor(_tangents("random", n, seed=seed)))
    return R.numpy().astype(dtype)


def _sim3_tangents(kind, n, seed, dtype):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(n, 3)), _tangents(kind, n, seed),
                           rng.uniform(-1.0, 1.0, size=(n, 1))],
                          axis=1).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["random", "tiny", "f32_switch"])
def test_so3_rest_matches_jax(kind, dtype):
    n = 64
    w = _tangents(kind, n).astype(dtype)
    Ra, Rb = _rotations(n, 4, dtype), _rotations(n, 5, dtype)
    p = np.random.default_rng(6).normal(size=(n, 3)).astype(dtype)
    ta, tb, tw, tp = (torch.as_tensor(x) for x in (Ra, Rb, w, p))
    ja, jb, jw, jp = (jnp.asarray(x) for x in (Ra, Rb, w, p))
    assert so3.DIM == jso3.DIM == 3
    _check(so3.vee(so3.hat(tw)), jax.vmap(lambda x: jso3.vee(jso3.hat(x)))(jw),
           dtype)
    _check(so3.jr(tw), jax.vmap(jso3.jr)(jw), dtype)
    _check(so3.jr_inv(tw), jax.vmap(jso3.jr_inv)(jw), dtype)
    _check(so3.mul(ta, tb), jax.vmap(jso3.mul)(ja, jb), dtype)
    _check(so3.inv(ta), jax.vmap(jso3.inv)(ja), dtype)
    _check(so3.adj(ta), jax.vmap(jso3.adj)(ja), dtype)
    _check(so3.act(ta, tp), jax.vmap(jso3.act)(ja, jp), dtype)
    _check(so3.act(ta[0], tp), jso3.act(ja[0], jp), dtype)     # many points
    _check(so3.local(ta, tb), jax.vmap(jso3.local)(ja, jb), dtype, _LTOL)
    q = so3.to_quat(ta)
    _check(so3.from_quat(q), jax.vmap(jso3.from_quat)(jnp.asarray(q.numpy())),
           dtype)
    M = Ra + 0.05 * p[:, :, None] * p[:, None, :].astype(dtype)
    _check(so3.project(torch.as_tensor(M)), jax.vmap(jso3.project)(
        jnp.asarray(M)), dtype, _LTOL)
    _check(so3.identity(tw.dtype, "cpu"), jso3.identity(dtype), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["random", "tiny", "f32_switch"])
def test_se3_rest_matches_jax(kind, dtype):
    n = 64
    rng = np.random.default_rng(7)
    xi = np.concatenate([rng.normal(size=(n, 3)), _tangents(kind, n)],
                        axis=1).astype(dtype)
    Ta = se3.exp(torch.as_tensor(xi))
    Tb = se3.SE3(torch.as_tensor(_rotations(n, 8, dtype)),
                 torch.as_tensor(rng.normal(size=(n, 3)).astype(dtype)))
    p = rng.normal(size=(n, 3)).astype(dtype)
    J = lambda T: jse3.SE3(jnp.asarray(T.R.numpy()),  # noqa: E731
                           jnp.asarray(T.t.numpy()))
    assert se3.DIM == jse3.DIM == 6
    _check(se3.adj(Ta), jax.vmap(jse3.adj)(J(Ta)), dtype)
    _check(se3.local(Ta, Tb), jax.vmap(jse3.local)(J(Ta), J(Tb)), dtype,
           _LTOL)
    _check(se3.log(Tb), jax.vmap(jse3.log)(J(Tb)), dtype, _LTOL)
    _check(se3.act(Ta, torch.as_tensor(p)),
           jax.vmap(jse3.act)(J(Ta), jnp.asarray(p)), dtype)
    Ti = se3.inv(Ta)
    _check(Ti.t, jax.vmap(jse3.inv)(J(Ta)).t, dtype)
    M = se3.to_matrix(Ta)
    _check(M, jax.vmap(jse3.to_matrix)(J(Ta)), dtype)
    back = se3.from_matrix(M)
    ref = jax.vmap(jse3.from_matrix)(jnp.asarray(M.numpy()))
    _check(back.R, ref.R, dtype)
    _check(back.t, ref.t, dtype)
    I = se3.identity(Ta.t.dtype, "cpu")
    _check(I.R, jse3.identity(dtype).R, dtype)
    _check(I.t, jse3.identity(dtype).t, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_so2_se2_match_jax(dtype):
    n = 64
    rng = np.random.default_rng(9)
    a = rng.uniform(-3.1, 3.1, n).astype(dtype)
    b = rng.uniform(-3.1, 3.1, n).astype(dtype)
    w = np.concatenate([rng.uniform(-3.0, 3.0, n // 2),
                        10.0 ** rng.uniform(-9, -4, n // 2)])[:, None]
    w = w.astype(dtype)
    p = rng.normal(size=(n, 2)).astype(dtype)
    ta, tb, tw, tp = (torch.as_tensor(x) for x in (a, b, w, p))
    ja, jb, jw, jp = (jnp.asarray(x) for x in (a, b, w, p))
    assert so2.DIM == jso2.DIM == 1 and se2.DIM == jse2.DIM == 3
    _check(so2.exp(tw), jax.vmap(jso2.exp)(jw), dtype)
    _check(so2.log(ta + 7.0), jax.vmap(jso2.log)(ja + 7.0), dtype, _LTOL)
    _check(so2.matrix(ta), jax.vmap(jso2.matrix)(ja), dtype)
    _check(so2.mul(ta, tb), jax.vmap(jso2.mul)(ja, jb), dtype, _LTOL)
    _check(so2.inv(ta), jax.vmap(jso2.inv)(ja), dtype)
    _check(so2.act(ta, tp), jax.vmap(jso2.act)(ja, jp), dtype)
    _check(so2.act(ta[0], tp), jso2.act(ja[0], jp), dtype)
    _check(so2.retract(ta, tw), jax.vmap(jso2.retract)(ja, jw), dtype, _LTOL)
    _check(so2.local(ta, tb), jax.vmap(jso2.local)(ja, jb), dtype, _LTOL)
    _check(so2.identity(ta.dtype, "cpu"), jso2.identity(dtype), dtype)

    xi = np.concatenate([p, w], axis=1)
    Ta = se2.exp(torch.as_tensor(xi))
    Ja = jax.vmap(jse2.exp)(jnp.asarray(xi))
    _check(Ta.theta, Ja.theta, dtype)
    _check(Ta.t, Ja.t, dtype)
    Tb = se2.SE2(tb, torch.as_tensor(p[::-1].copy()))
    Jb = jse2.SE2(jb, jp[::-1])
    _check(se2.log(Tb), jax.vmap(jse2.log)(Jb), dtype, _LTOL)
    _check(se2.local(Ta, Tb), jax.vmap(jse2.local)(Ja, Jb), dtype, _LTOL)
    for name in ("mul", "retract"):
        other = (Tb, Jb) if name == "mul" else (torch.as_tensor(xi[::-1]
                                                                .copy()),
                                                 jnp.asarray(xi[::-1]))
        got = getattr(se2, name)(Ta, other[0])
        want = jax.vmap(getattr(jse2, name))(Ja, other[1])
        _check(got.theta, want.theta, dtype, _LTOL)
        _check(got.t, want.t, dtype, _LTOL)
    _check(se2.inv(Ta).t, jax.vmap(jse2.inv)(Ja).t, dtype)
    _check(se2.act(Ta, tp), jax.vmap(jse2.act)(Ja, jp), dtype)
    _check(se2.matrix(Ta), jax.vmap(jse2.matrix)(Ja), dtype)
    _check(se2.identity(ta.dtype, "cpu").t, jse2.identity(dtype).t, dtype)


def _sim3_pair(S):
    return jsim3.Sim3(*(jnp.asarray(x.numpy()) for x in S))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["random", "tiny", "f32_switch"])
def test_sim3_matches_jax(kind, dtype):
    n = 64
    xi = _sim3_tangents(kind, n, 10, dtype)
    Sa = sim3.exp(torch.as_tensor(xi))
    Ja = jax.vmap(jsim3.exp)(jnp.asarray(xi))
    for got, want in zip(Sa, Ja):
        _check(got, want, dtype)
    assert sim3.DIM == jsim3.DIM == 7
    Sb = sim3.exp(torch.as_tensor(_sim3_tangents("random", n, 11, dtype)))
    Jb = _sim3_pair(Sb)
    _check(sim3.log(Sa), jax.vmap(jsim3.log)(_sim3_pair(Sa)), dtype, _LTOL)
    _check(sim3.local(Sa, Sb), jax.vmap(jsim3.local)(_sim3_pair(Sa), Jb),
           dtype, _LTOL)
    _check(sim3._W(torch.as_tensor(xi[:, 3:6]), torch.as_tensor(xi[:, 6])),
           jax.vmap(jsim3._W)(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])),
           dtype)
    JSa = _sim3_pair(Sa)
    for name in ("mul", "retract"):
        other = (Sb, Jb) if name == "mul" else (
            torch.as_tensor(xi[::-1].copy()), jnp.asarray(xi[::-1]))
        got = getattr(sim3, name)(Sa, other[0])
        want = jax.vmap(getattr(jsim3, name))(JSa, other[1])
        for g, w in zip(got, want):
            _check(g, w, dtype, _LTOL)
    for g, w in zip(sim3.inv(Sa), jax.vmap(jsim3.inv)(JSa)):
        _check(g, w, dtype, _LTOL)
    p = np.random.default_rng(12).normal(size=(n, 3)).astype(dtype)
    _check(sim3.act(Sa, torch.as_tensor(p)),
           jax.vmap(jsim3.act)(JSa, jnp.asarray(p)), dtype, _LTOL)
    _check(sim3.adj(Sa), jax.vmap(jsim3.adj)(JSa), dtype, _LTOL)
    M = sim3.to_matrix(Sa)
    _check(M, jax.vmap(jsim3.to_matrix)(JSa), dtype, _LTOL)
    for g, w in zip(sim3.from_matrix(M),
                    jax.vmap(jsim3.from_matrix)(jnp.asarray(M.numpy()))):
        _check(g, w, dtype, _LTOL)
    T = se3.SE3(Sa.R, Sa.t)
    for g, w in zip(sim3.from_se3(T, Sa.s),
                    jax.vmap(jsim3.from_se3)(jse3.SE3(JSa.R, JSa.t), JSa.s)):
        _check(g, w, dtype)
    for g, w in zip(sim3.identity(Sa.t.dtype, "cpu"), jsim3.identity(dtype)):
        _check(g, w, dtype)


def test_sim3_from_matrix_negative_determinant():
    """A reflection gives a negative scale, as the JAX package's cube root
    of the determinant does (copied, not repaired)."""
    M = np.diag([-2.0, -2.0, -2.0, 1.0])
    got = sim3.from_matrix(torch.as_tensor(M))
    want = jsim3.from_matrix(jnp.asarray(M))
    assert float(got.s) == pytest.approx(float(want.s)) == -2.0
    _check(got.R, want.R, np.float64)


def test_random_draws_are_group_elements():
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float64, torch.float32):
        eps = 1e-12 if dtype == torch.float64 else 1e-5
        R = so3.random(g, dtype, (50,), "cpu")
        T = se3.random(g, dtype, 2.0, (50,), "cpu")
        S = sim3.random(g, dtype, 2.0, 0.3, (50,), "cpu")
        for Rx in (R, T.R, S.R):
            assert Rx.dtype == dtype and Rx.shape == (50, 3, 3)
            err = (Rx.mT @ Rx - torch.eye(3, dtype=dtype)).abs().max()
            assert float(err) < 10 * eps
            assert float((torch.linalg.det(Rx) - 1).abs().max()) < 10 * eps
        assert bool((S.s > 0).all()) and T.t.shape == (50, 3)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_manifold_round_trips_match_jax(dtype):
    """Each combinator's retract and local against the JAX package's, and
    local(x, retract(x, d)) = d, batched over 8 copies."""
    n = 8
    rng = np.random.default_rng(13)
    R = _rotations(n, 14, dtype)
    t = rng.normal(size=(n, 3)).astype(dtype)
    v = rng.normal(size=(n, 2, 2)).astype(dtype)
    T_t = se3.SE3(torch.as_tensor(R), torch.as_tensor(t))
    T_j = jse3.SE3(jnp.asarray(R), jnp.asarray(t))
    pairs = [
        (manifold.lie(se3), jmanifold.lie(jse3), T_t, T_j),
        (manifold.so3_r3(), jmanifold.so3_r3(), T_t, T_j),
        (manifold.euclidean((2, 2)), jmanifold.euclidean((2, 2)),
         torch.as_tensor(v), jnp.asarray(v)),
        (manifold.product(manifold.lie(se3), manifold.euclidean((2, 2))),
         jmanifold.product(jmanifold.lie(jse3), jmanifold.euclidean((2, 2))),
         (T_t, torch.as_tensor(v)), (T_j, jnp.asarray(v))),
    ]
    for m_t, m_j, x_t, x_j in pairs:
        assert m_t.dim == m_j.dim
        b_t, b_j = manifold.batched(m_t, n), jmanifold.batched(m_j, n)
        assert b_t.dim == b_j.dim == n * m_t.dim
        d = (0.3 * rng.normal(size=b_t.dim)).astype(dtype)
        y_t = b_t.retract(x_t, torch.as_tensor(d))
        y_j = b_j.retract(x_j, jnp.asarray(d))
        for a, b in zip(jax.tree_util.tree_leaves(y_t),
                        jax.tree_util.tree_leaves(y_j)):
            _check(a, b, dtype)
        back = b_t.local(x_t, y_t)
        _check(back, b_j.local(x_j, y_j), dtype, _LTOL)
        _check(back, d, dtype, _LTOL)
    lie_sim3 = manifold.lie(sim3)
    S = sim3.exp(torch.as_tensor(_sim3_tangents("random", n, 15, dtype)))
    d = torch.as_tensor((0.3 * rng.normal(size=(n, 7))).astype(dtype))
    _check(lie_sim3.local(S, lie_sim3.retract(S, d)), d.numpy(), dtype, _LTOL)
