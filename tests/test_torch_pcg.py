"""slam_tricks_tpu_torch/solvers/pcg.py and ops/smallchol.py against the JAX
package's pcg.py and smallchol.py, in f64, on the scene of
tests/test_pcg.py.

Tolerances: the unrolled small Cholesky and its solves to 1e-12 relative;
band pairs equal; the tridiagonal blocks to the dense S and to the JAX
package's blocks at 1e-12 relative; the preconditioner (the stored factor of
banded_flat) against the JAX package's make_tridiag_precond at 1e-10
relative; the matvec at 1e-12; a PCG step against the JAX package's PCG
step at atol 1e-8 (tests/test_pcg.py's bound against the dense step); the
CG loop's iteration count within one of the JAX loop's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.ops import smallchol as jsmallchol
from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import pcg as jpcg
from slam_tricks_tpu.solvers import schur as jschur
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.ops import smallchol
from slam_tricks_tpu_torch.sim import make_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import pcg, schur
from tests.torch_util import rel_err

f64 = torch.float64
LAM = 1e-3


@pytest.mark.parametrize("n", [3, 6])
def test_smallchol_matches_jax(n):
    rng = np.random.default_rng(17 + n)
    A = rng.normal(size=(50, n, n))
    A = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    b = rng.normal(size=(50, n))
    B = rng.normal(size=(50, n, 4))
    Lj = jsmallchol.cholesky_small(jnp.asarray(A))
    L = smallchol.cholesky_small(torch.as_tensor(A))
    assert rel_err(L, Lj) < 1e-12
    assert rel_err(smallchol.cho_solve_small(torch.as_tensor(A),
                                             torch.as_tensor(b)),
                   jsmallchol.cho_solve_small(jnp.asarray(A),
                                              jnp.asarray(b))) < 1e-12
    assert rel_err(smallchol.solve_lower_small(L, torch.as_tensor(B)),
                   jsmallchol.solve_lower_small(Lj, jnp.asarray(B))) < 1e-12
    assert rel_err(smallchol.solve_lower_t_small(L, torch.as_tensor(B)),
                   jsmallchol.solve_lower_t_small(Lj, jnp.asarray(B))) < 1e-12
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(A), atol=1e-10)


@pytest.fixture(scope="module")
def prob():
    kw = dict(n_per_wall=10, n_cams=6, seed=41)
    jsc = jmake_scene(dtype=np.float64, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=42)
    sc = make_scene(dtype=f64, device="cpu", **kw)
    p0, x0, fx = perturb_scene(sc, seed=42)
    C, L = sc.n_cams, sc.n_points
    jo, o = jsc.obs, sc.obs
    jb = jschur._assemble(*jschur._linearize_obs(jp0, jx0, jo.cam_idx,
                                                 jo.lm_idx, jo.uv, jo.weight),
                          jo.cam_idx, jo.lm_idx, C, L)
    b = schur._assemble(*schur._linearize_obs(p0, x0, o.cam_idx, o.lm_idx,
                                              o.uv, o.weight),
                        o.cam_idx, o.lm_idx, C, L)
    # the damped blocks both packages' PCG build
    lam = jnp.asarray(LAM)
    d = jnp.maximum(jnp.diagonal(jb[0], axis1=-2, axis2=-1), 1e-12)
    jHpp_d = jb[0] + lam * jax.vmap(jnp.diag)(d)
    jHll_inv = jschur._inv3x3(jschur._damp_hll(jb[1], lam))
    lam_t = torch.tensor(LAM, dtype=f64)
    Hpp_d = schur._damp_blocks(b[0], lam_t)
    Hll_inv = schur._inv3x3(schur._damp_hll(b[1], lam_t))
    return dict(jsc=jsc, sc=sc, jfx=jfx, fx=fx, jb=jb, b=b, C=C, L=L,
                jHpp_d=jHpp_d, jHll_inv=jHll_inv, Hpp_d=Hpp_d,
                Hll_inv=Hll_inv)


def test_build_band_pairs_equal(prob):
    jo, o = prob["jsc"].obs, prob["sc"].obs
    jbp = jpcg.build_band_pairs(jo.cam_idx, jo.lm_idx, dtype=np.float64)
    bp = pcg.build_band_pairs(o.cam_idx, o.lm_idx, dtype=f64)
    for name, a, ref in zip(pcg.BandPairs._fields, bp, jbp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ref), name)
    conv = interop.band_pairs_from_jax(jbp, "cpu")
    for a, b in zip(conv, bp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _dense_S(p):
    """The gauge-fixed damped S (C, 6, C, 6) of the port's blocks, dense."""
    o, C, L = p["sc"].obs, p["C"], p["L"]
    W = torch.zeros((C, L, 6, 3), dtype=f64)
    W.index_put_((o.cam_idx.long(), o.lm_idx.long()), p["b"][4],
                 accumulate=True)
    WH = torch.einsum("clij,ljk->clik", W, p["Hll_inv"])
    S = -torch.einsum("clik,elmk->ciem", WH, W)
    ci = torch.arange(C)
    S[ci, :, ci, :] += p["Hpp_d"]
    free = (~p["fx"]).double()
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[ci, :, ci, :] += p["fx"].double()[:, None, None] * torch.eye(6)
    return S


def test_assemble_tridiag_matches_dense_and_jax(prob):
    p = prob
    jo, o = p["jsc"].obs, p["sc"].obs
    bp = pcg.build_band_pairs(o.cam_idx, o.lm_idx, dtype=f64)
    jbp = jpcg.build_band_pairs(jo.cam_idx, jo.lm_idx, dtype=np.float64)
    free = (~p["fx"]).double()
    D, E = pcg.assemble_tridiag(p["Hpp_d"], p["Hll_inv"], p["b"][4],
                                o.cam_idx, o.lm_idx, free, bp)
    jD, jE = jpcg.assemble_tridiag(p["jHpp_d"], p["jHll_inv"], p["jb"][4],
                                   jo.cam_idx, jo.lm_idx,
                                   (~p["jfx"]).astype(jnp.float64), jbp)
    assert rel_err(D, jD) < 1e-12 and rel_err(E, jE) < 1e-12
    S = _dense_S(p)
    ci = torch.arange(p["C"])
    assert rel_err(D, S[ci, :, ci, :]) < 1e-12
    assert rel_err(E, S[ci[1:], :, ci[:-1], :]) < 1e-12


def test_tridiag_precond_on_stored_factor_matches_jax(prob):
    p = prob
    jo, o = p["jsc"].obs, p["sc"].obs
    bp = pcg.build_band_pairs(o.cam_idx, o.lm_idx, dtype=f64)
    D, E = pcg.assemble_tridiag(p["Hpp_d"], p["Hll_inv"], p["b"][4],
                                o.cam_idx, o.lm_idx, (~p["fx"]).double(), bp)
    r = np.random.default_rng(3).normal(size=(p["C"], 6))
    z = pcg.make_tridiag_precond(D, E)(torch.as_tensor(r))
    zj = jpcg.make_tridiag_precond(jnp.asarray(D.numpy()),
                                   jnp.asarray(E.numpy()))(jnp.asarray(r))
    assert rel_err(z, zj) < 1e-10
    # and it solves tridiag(S) z = r
    C = p["C"]
    T = torch.zeros((C, 6, C, 6), dtype=f64)
    ci = torch.arange(C)
    T[ci, :, ci, :] = D
    T[ci[1:], :, ci[:-1], :] = E
    T[ci[:-1], :, ci[1:], :] = E.mT
    z_ref = torch.linalg.solve(T.reshape(6 * C, 6 * C),
                               torch.as_tensor(r).reshape(-1))
    assert rel_err(z.reshape(-1), z_ref) < 1e-10


def test_matvec_matches_jax_and_dense(prob):
    p = prob
    jo, o = p["jsc"].obs, p["sc"].obs
    x = np.random.default_rng(5).normal(size=(p["C"], 6))
    mv = pcg.make_schur_matvec(p["Hpp_d"], p["Hll_inv"], p["b"][4], o.cam_idx,
                               o.lm_idx, p["L"])
    jmv = jpcg.make_schur_matvec(p["jHpp_d"], p["jHll_inv"], p["jb"][4],
                                 jo.cam_idx, jo.lm_idx, p["L"])
    y = mv(torch.as_tensor(x))
    assert rel_err(y, jmv(jnp.asarray(x))) < 1e-12
    # against the dense S with no gauge (the gauge is the solver's)
    C, L = p["C"], p["L"]
    W = torch.zeros((C, L, 6, 3), dtype=f64)
    W.index_put_((o.cam_idx.long(), o.lm_idx.long()), p["b"][4],
                 accumulate=True)
    WH = torch.einsum("clij,ljk->clik", W, p["Hll_inv"])
    S = -torch.einsum("clik,elmk->ciem", WH, W)
    ci = torch.arange(C)
    S[ci, :, ci, :] += p["Hpp_d"]
    assert rel_err(y, torch.einsum("ciej,ej->ci", S, torch.as_tensor(x))) < 1e-12


@pytest.mark.parametrize("band", [False, True])
def test_pcg_step_matches_jax(prob, band):
    p = prob
    jo, o = p["jsc"].obs, p["sc"].obs
    C, L = p["C"], p["L"]
    kw, jkw = {}, {}
    if band:
        kw["band_pairs"] = pcg.build_band_pairs(o.cam_idx, o.lm_idx, dtype=f64)
        jkw["band_pairs"] = jpcg.build_band_pairs(jo.cam_idx, jo.lm_idx,
                                                  dtype=np.float64)
    jdp, jdl = jpcg.solve_rcs_pcg(*p["jb"][:5], jo.cam_idx, jo.lm_idx,
                                  jnp.asarray(LAM), p["jfx"], L, cg_iters=300,
                                  cg_tol=1e-14, **jkw)
    Hpp, Hll, gp, gl, W = p["b"]
    dp, dl = pcg.solve_rcs_pcg(Hpp, Hll, gp, gl, W, o.cam_idx, o.lm_idx,
                               torch.tensor(LAM, dtype=f64), p["fx"], L,
                               cg_iters=300, cg_tol=1e-14, **kw)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), atol=1e-8)
    np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), atol=1e-8)
    # and the exact dense step
    ddp, ddl = schur._schur_reduce(Hpp, Hll, gp, gl, W, o.cam_idx, o.lm_idx,
                                   torch.tensor(LAM, dtype=f64), C, L,
                                   p["fx"])
    np.testing.assert_allclose(dp.numpy(), ddp.numpy(), atol=1e-8)
    np.testing.assert_allclose(dl.numpy(), ddl.numpy(), atol=1e-8)


def test_pcg_frozen_loop_matches_jax_iterations(prob):
    """The host loop that freezes its updates once done and reads the flag
    every few iterations stops where the JAX while_loop stops (within one
    iteration: the stop is a threshold on a residual that the two round
    differently), and reading the flag every iteration changes no bit. The iterates agree to 1e-6
    relative (CG amplifies the rounding of the summation order: after the
    early stop at 1e-4 they differ by ~2e-7)."""
    p = prob
    jo, o = p["jsc"].obs, p["sc"].obs
    C, L = p["C"], p["L"]
    free = (~p["fx"]).double()
    mv0 = pcg.make_schur_matvec(p["Hpp_d"], p["Hll_inv"], p["b"][4],
                                o.cam_idx, o.lm_idx, L)
    mv = lambda x: mv0(x * free[:, None]) * free[:, None] + x * (1 - free)[:, None]  # noqa: E731
    jfree = (~p["jfx"]).astype(jnp.float64)
    jmv0 = jpcg.make_schur_matvec(p["jHpp_d"], p["jHll_inv"], p["jb"][4],
                                  jo.cam_idx, jo.lm_idx, L)
    jmv = lambda x: jmv0(x * jfree[:, None]) * jfree[:, None] + x * (1 - jfree)[:, None]  # noqa: E731
    M = (p["Hpp_d"] * free[:, None, None]
         + torch.eye(6, dtype=f64) * (1 - free)[:, None, None])
    b = torch.as_tensor(np.random.default_rng(7).normal(size=(C, 6))) * free[:, None]
    pre = lambda r: smallchol.cho_solve_small(M, r)  # noqa: E731
    jpre = lambda r: jsmallchol.cho_solve_small(jnp.asarray(M.numpy()), r)  # noqa: E731
    for tol in (1e-4, 1e-10):
        x, it = pcg.pcg(mv, b, pre, iters=200, tol=tol)
        x1, it1 = pcg.pcg(mv, b, pre, iters=200, tol=tol, check_every=1)
        jx, jit = jpcg.pcg(jmv, jnp.asarray(b.numpy()), jpre, iters=200,
                           tol=tol)
        assert int(it) == int(it1) < 200
        assert abs(int(it) - int(jit)) <= 1, (tol, int(it), int(jit))
        assert torch.equal(x, x1)
        assert rel_err(x, jx) < 1e-6
