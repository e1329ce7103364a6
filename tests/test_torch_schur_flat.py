"""slam_tricks_tpu_torch/solvers/schur_flat.py against the JAX package's
schur_flat on the scene of tests/test_schur_flat.py, in f64.

The port lays the observations on the slot grid of their track table and
linearizes with ops.ba_assemble (its plain version here), so W is compared
at each observation's slot. Tolerances: the blocks and the cost to 1e-12
relative; the first damped step, with and without a prior, to 1e-9
relative; whole solves (pix_noise 1e-3, above the f64 floor) in the
iteration count, the cost to rtol 1e-8 and the state to 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.residuals import robust as jrobust
from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import schur_flat as jflat
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.sim import make_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import schur_flat
from tests.torch_util import rel_err

f64 = torch.float64


def _problem(pix_noise=0.0, seed=21, grid=False):
    kw = dict(n_per_wall=10, n_cams=6, seed=seed, pix_noise=pix_noise)
    jsc = jmake_scene(dtype=np.float64, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=seed + 1)
    sc = make_scene(dtype=f64, device="cpu", **kw)
    p0, x0, fx = perturb_scene(sc, seed=seed + 1)
    C, L = sc.n_cams, sc.n_points
    jobs, obs = jsc.obs, sc.obs
    if grid:
        jobs = jflat.grid_order_obs(jobs, L, dtype=np.float64)
        obs = schur_flat.grid_order_obs(obs, L, dtype=f64)
    jwork = jflat.build_flat_work(jobs, C, L, dtype=np.float64, grid=grid)
    work = schur_flat.build_flat_work(obs, C, L, dtype=f64, grid=grid)
    return (jobs, jp0, jx0, jfx, jwork), (obs, p0, x0, fx, work), (C, L)


@pytest.fixture(scope="module")
def prob():
    return _problem()


def test_flat_work_and_interop(prob):
    (jobs, *_, jwork), (obs, *_, work), (C, L) = prob
    conv = interop.flat_work_from_jax(jwork, jobs, C, "cpu")
    for name in ("uv0", "uv1", "w", "mask", "cam_of_slot"):
        np.testing.assert_array_equal(getattr(work.slot, name).numpy(),
                                      getattr(conv.slot, name).numpy(), name)
    np.testing.assert_array_equal(work.obs_slot.numpy(),
                                  conv.obs_slot.numpy())
    # each live observation sits at its slot, with its measurement
    live = work.obs_slot >= 0
    s = work.obs_slot[live]
    np.testing.assert_array_equal(work.slot.uv0.reshape(-1)[s].numpy(),
                                  obs.uv[live, 0].numpy())
    assert int(live.sum()) == int((obs.weight > 0).sum())


def _quantities(prob):
    (jobs, jp0, jx0, jfx, jwork), (obs, p0, x0, fx, work), (C, L) = prob
    jq = jflat._iteration_quantities(jp0, jx0, jobs, jwork, C, L)
    q = schur_flat._iteration_quantities(p0, x0, work)
    return jq, q


def test_iteration_quantities_match_jax(prob):
    (jobs, *_), (obs, *_, work), (C, L) = prob
    (jHpp, jgp, jHll, jgl, jW, jcost), (Hpp, gp, Hll, gl, W, cost) = \
        _quantities(prob)
    assert rel_err(Hpp, jHpp) < 1e-12
    assert rel_err(gp, jgp) < 1e-12
    assert rel_err(Hll, jnp.stack(jHll)) < 1e-12
    assert rel_err(gl, jnp.asarray(jgl).T) < 1e-12
    live = (work.obs_slot >= 0).numpy()
    W_obs = W.reshape(18, -1)[:, work.obs_slot[live]].T
    assert rel_err(W_obs, np.asarray(jW)[live]) < 1e-12
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-12)


@pytest.mark.parametrize("with_prior", [False, True])
def test_solve_flat_matches_jax(prob, with_prior):
    (_, _, _, jfx, jwork), (_, _, _, fx, work), (C, L) = prob
    jq, q = _quantities(prob)
    lam = 1e-4
    jprior = prior = None
    if with_prior:
        # a prior on the first two cameras, which must be free: fix the
        # last camera instead of the first
        fx = torch.zeros(C, dtype=torch.bool)
        fx[-1] = True
        jfx = jnp.asarray(fx.numpy())
        rng = np.random.default_rng(1)
        A = rng.normal(size=(12, 12))
        H = A @ A.T + 12 * np.eye(12)
        g = rng.normal(size=12)
        jprior = (jnp.asarray(H), jnp.asarray(g))
        prior = (torch.as_tensor(H), torch.as_tensor(g))
    ref = jflat._solve_flat(jq[0], jq[1], list(jq[2]), jq[3], jq[4],
                            jnp.asarray(lam), jfx, jwork, C, L, prior=jprior)
    out = schur_flat._solve_flat(*q[:5], torch.tensor(lam, dtype=f64), fx,
                                 work, prior=prior)
    for name, a, r in zip(("dp", "dl", "diag_pp", "diag_ll"), out, ref):
        assert a.shape == r.shape, name
        assert rel_err(a, r) < 1e-9, (name, rel_err(a, r))


def _compare(out, ref):
    assert out.it == int(ref.it)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-8)
    for a, r in ((out.poses.R, ref.poses.R), (out.poses.t, ref.poses.t),
                 (out.points, ref.points)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)


@pytest.mark.parametrize("variant", ["dense", "huber", "grid"])
def test_solve_ba_flat_matches_jax(variant):
    (jobs, jp0, jx0, jfx, jwork), (obs, p0, x0, fx, work), _ = _problem(
        pix_noise=1e-3, grid=variant == "grid")
    jkw, kw = {}, {}
    if variant == "huber":
        jkw["loss"], kw["loss"] = jrobust.huber(2e-3), robust.huber(2e-3)
    ref = jflat.solve_ba_flat(jp0, jx0, jobs, jwork, fixed_mask=jfx,
                              max_iters=10, **jkw)
    out = schur_flat.solve_ba_flat(p0, x0, obs, work, fixed_mask=fx,
                                   max_iters=10, **kw)
    _compare(out, ref)


def test_grid_layout_and_argument_errors(prob):
    (_, *_), (obs, p0, x0, fx, work), (C, L) = prob
    with pytest.raises(ValueError, match="grid_order_obs"):
        schur_flat.build_flat_work(obs, C, L, dtype=f64, grid=True)
    # the JAX package's rule: the distributed solve is PCG only
    with pytest.raises(ValueError, match="psum_axis requires"):
        schur_flat.solve_ba_flat(p0, x0, obs, work, linear="dense",
                                 psum_axis="d")
    with pytest.raises(ValueError, match="pcg_work"):
        schur_flat.solve_ba_flat(p0, x0, obs, work, linear="pcg")
    with pytest.raises(ValueError, match="observations"):
        schur_flat.solve_ba_flat(p0, x0, obs._replace(uv=obs.uv[:-8]), work)
