"""slam_tricks_tpu_torch/solvers/schur.py's observation-list solver against
the JAX package's schur.solve_ba on the small scenes of
tests/test_schur_ba.py, in f64.

Tolerances: the linearization and the blocks to 1e-12 relative (the same
arithmetic, sums in another order); the first damped steps of the exact
solvers ("dense", "paired", and "tracks", which runs the dense solve in the
port) to 1e-9 relative, each against the JAX package's same solver and
against its dense step; whole solves
(pix_noise 1e-3, so that both stop above the f64 floor) in the iteration
count, the cost to rtol 1e-8 and the poses and points to 1e-8; the PCG
solve as the JAX package's own PCG tests hold it (atol 1e-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.residuals import robust as jrobust
from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import schur as jschur
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.sim import make_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import schur
from tests.torch_util import rel_err

f64 = torch.float64


def _problem(pix_noise=0.0, seed=3, pseed=11, n_per_wall=10):
    kw = dict(n_per_wall=n_per_wall, n_cams=6, seed=seed, pix_noise=pix_noise)
    jsc = jmake_scene(dtype=np.float64, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=pseed)
    sc = make_scene(dtype=f64, device="cpu", **kw)
    p0, x0, fx = perturb_scene(sc, seed=pseed)
    return (jsc, jp0, jx0, jfx), (sc, p0, x0, fx)


def _blocks(jprob, prob):
    jsc, jp0, jx0, _ = jprob
    sc, p0, x0, _ = prob
    o, jo = sc.obs, jsc.obs
    C, L = sc.n_cams, sc.n_points
    jr, jJp, jJl = jschur._linearize_obs(jp0, jx0, jo.cam_idx, jo.lm_idx,
                                         jo.uv, jo.weight)
    jb = jschur._assemble(jr, jJp, jJl, jo.cam_idx, jo.lm_idx, C, L)
    r, Jp, Jl = schur._linearize_obs(p0, x0, o.cam_idx, o.lm_idx, o.uv,
                                     o.weight)
    b = schur._assemble(r, Jp, Jl, o.cam_idx, o.lm_idx, C, L)
    return (jr, jJp, jJl), jb, (r, Jp, Jl), b


@pytest.fixture(scope="module")
def step_problem():
    jprob, prob = _problem()
    return jprob, prob, _blocks(jprob, prob)


def test_linearize_and_assemble_blocks(step_problem):
    jprob, prob, (jlin, jb, lin, b) = step_problem
    for name, a, ref in zip(("r", "Jp", "Jl"), lin, jlin):
        assert rel_err(a, ref) < 1e-12, name
    for name, a, ref in zip(("Hpp", "Hll", "gp", "gl", "W_obs"), b, jb):
        assert a.shape == ref.shape, name
        assert rel_err(a, ref) < 1e-12, (name, rel_err(a, ref))
    jsc, jp0, jx0, _ = jprob
    sc, p0, x0, _ = prob
    o = sc.obs
    cost = schur._cost(p0, x0, o.cam_idx, o.lm_idx, o.uv, o.weight)
    jcost = jschur._cost(jp0, jx0, jsc.obs.cam_idx, jsc.obs.lm_idx,
                         jsc.obs.uv, jsc.obs.weight)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-12)


def _steps(jprob, prob, blocks):
    """dp, dl of each exact solver at lam = 1e-3: the JAX dense step and
    the port's dense and paired steps."""
    jsc, _, _, jfx = jprob
    sc, _, _, fx = prob
    _, jb, _, b = blocks
    o, jo = sc.obs, jsc.obs
    C, L = sc.n_cams, sc.n_points
    lam = 1e-3
    ref = jschur._schur_reduce(*jb, jo.cam_idx, jo.lm_idx, jnp.asarray(lam),
                               C, L, jfx)
    lam_t = torch.tensor(lam, dtype=f64)
    pairs = schur.build_track_pairs(o.cam_idx, o.lm_idx, chunk=257, dtype=f64)
    out = {
        "dense": schur._schur_reduce(*b, o.cam_idx, o.lm_idx, lam_t, C, L,
                                     fx),
        "paired": schur._schur_reduce_paired(*b, o.cam_idx, o.lm_idx, lam_t,
                                             C, L, fx, pairs),
    }
    return ref, out


@pytest.mark.parametrize("solver", ["dense", "paired"])
def test_exact_steps_match_jax_dense_step(step_problem, solver):
    jprob, prob, blocks = step_problem
    ref, out = _steps(jprob, prob, blocks)
    for name, a, r in zip(("dp", "dl"), out[solver], ref):
        assert rel_err(a, r) < 1e-9, (solver, name, rel_err(a, r))


def test_paired_and_tracks_steps_match_jax_own(step_problem):
    """The port's paired step against the JAX package's own paired
    reduction of the same blocks, and the port's tracks step (its dense
    reduction of its own blocks) against the JAX package's tracks
    assembly and reduction."""
    jprob, prob, (_, jb, _, b) = step_problem
    jsc, _, _, jfx = jprob
    sc, _, _, fx = prob
    jo, o = jsc.obs, sc.obs
    C, L = sc.n_cams, sc.n_points
    lam = jnp.asarray(1e-3)
    jpairs = jschur.build_track_pairs(jo.cam_idx, jo.lm_idx, chunk=257,
                                      dtype=np.float64)
    jtable = jschur.build_track_table(jo.cam_idx, jo.lm_idx, jo.weight,
                                      n_points=L, dtype=np.float64)
    jp = jschur._schur_reduce_paired(*jb, jo.cam_idx, jo.lm_idx, lam, C, L,
                                     jfx, jpairs)
    jr, jJp, jJl = jschur._linearize_obs(*jprob[1:3], jo.cam_idx, jo.lm_idx,
                                         jo.uv, jo.weight)
    jbt = jschur._assemble_tracks(jr, jJp, jJl, jo.cam_idx, jtable, C, L)
    jt = jschur._schur_reduce_tracks(*jbt, jo.cam_idx, jo.lm_idx, lam, C, L,
                                     jfx, jtable)
    lam_t = torch.tensor(1e-3, dtype=f64)
    pairs = interop.track_pairs_from_jax(jpairs, "cpu")
    for name, a, ref in zip(("Hpp", "Hll", "gp", "gl", "W_obs"), b, jbt):
        assert rel_err(a, ref) < 1e-12, ("tracks blocks", name)
    got_p = schur._schur_reduce_paired(*b, o.cam_idx, o.lm_idx, lam_t, C, L,
                                       fx, pairs)
    got_t = schur._schur_reduce(*b, o.cam_idx, o.lm_idx, lam_t, C, L, fx)
    for label, got, ref in (("paired", got_p, jp), ("tracks", got_t, jt)):
        for name, a, r_ in zip(("dp", "dl"), got, ref):
            assert rel_err(a, r_) < 1e-9, (label, name, rel_err(a, r_))


def test_build_track_pairs_arrays_equal():
    jprob, prob = _problem()
    jo, o = jprob[0].obs, prob[0].obs
    for chunk in (257, 65536):
        jp = jschur.build_track_pairs(jo.cam_idx, jo.lm_idx, chunk=chunk,
                                      dtype=np.float64)
        p = schur.build_track_pairs(o.cam_idx, o.lm_idx, chunk=chunk,
                                    dtype=f64)
        for name, a, ref in zip(schur.TrackPairs._fields, p, jp):
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(ref), name)


def test_pair_segments_cover_every_pair_once():
    _, prob = _problem()
    o = prob[0].obs
    C = prob[0].n_cams
    pairs = schur.build_track_pairs(o.cam_idx, o.lm_idx, chunk=257, dtype=f64)
    segs = schur.pair_segments(pairs, o.cam_idx, C)
    n = o.cam_idx.shape[0]
    a, b = segs.a.reshape(-1), segs.b.reshape(-1)
    live = a < n
    assert torch.equal(live, b < n)
    got = torch.sort(torch.minimum(a[live], b[live]) * n
                     + torch.maximum(a[live], b[live])).values
    w = pairs.pair_w.reshape(-1) > 0
    pa, pb = pairs.pair_a.reshape(-1)[w].long(), pairs.pair_b.reshape(-1)[w].long()
    want = torch.sort(torch.minimum(pa, pb) * n + torch.maximum(pa, pb)).values
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # every segment holds one block's pairs, cam_a <= cam_b, all a == b or
    # none (they count half)
    cam = o.cam_idx.long()
    for ra, rb, sw in zip(segs.a, segs.b, segs.seg_w.reshape(-1)):
        ra, rb = ra[ra < n], rb[rb < n]
        assert torch.unique(cam[ra] * C + cam[rb]).numel() == 1
        assert bool((cam[ra] <= cam[rb]).all())
        assert bool(((ra == rb) == (sw == 0.5)).all())


def _solver_kwargs(solver, jo, o, L):
    if solver == "paired":
        return ({"track_pairs": jschur.build_track_pairs(
                    jo.cam_idx, jo.lm_idx, chunk=1024, dtype=np.float64)},
                {"track_pairs": schur.build_track_pairs(
                    o.cam_idx, o.lm_idx, chunk=1024, dtype=f64)})
    if solver == "tracks":
        return ({"track_table": jschur.build_track_table(
                    jo.cam_idx, jo.lm_idx, jo.weight, n_points=L,
                    dtype=np.float64)},
                {"track_table": schur.build_track_table(
                    o.cam_idx.numpy(), o.lm_idx.numpy(), o.weight.numpy(),
                    n_points=L, dtype=np.float64)})
    return {}, {}


@pytest.mark.parametrize("solver", ["dense", "paired", "tracks", "pcg"])
def test_solve_ba_matches_jax(solver):
    (jsc, jp0, jx0, jfx), (sc, p0, x0, fx) = _problem(pix_noise=1e-3,
                                                      pseed=9)
    jkw, kw = _solver_kwargs(solver, jsc.obs, sc.obs, sc.n_points)
    ref = jschur.solve_ba(jp0, jx0, jsc.obs, fixed_mask=jfx, max_iters=12,
                          linear_solver=solver, **jkw)
    costs = []
    out = schur.solve_ba(p0, x0, sc.obs, fixed_mask=fx, max_iters=12,
                         linear_solver=solver, costs=costs, **kw)
    assert out.it == int(ref.it)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-8)
    for a, r in ((out.poses.R, ref.poses.R), (out.poses.t, ref.poses.t),
                 (out.points, ref.points)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)
    c = [float(v) for v in costs]
    assert len(c) == out.it + 1 and all(b <= a for a, b in zip(c, c[1:]))


def test_solve_ba_huber_gtol_callback_match_jax():
    """Huber IRLS, a gradient stop and the per-step callback, together:
    the same steps, the same stop, the same (it, cost, lam) reports."""
    (jsc, jp0, jx0, jfx), (sc, p0, x0, fx) = _problem(pix_noise=1e-3,
                                                      pseed=9)
    # a gradient bound just above the gradient (the fixed camera's
    # included, as the JAX package's test of it does) after three steps
    third = schur.solve_ba(p0, x0, sc.obs, fixed_mask=fx, max_iters=3,
                           loss=robust.huber(2e-3))
    o = sc.obs
    s_ = (schur._residuals(third.poses, third.points, o.cam_idx, o.lm_idx,
                           o.uv) ** 2).sum(1)
    lin = schur._linearize_obs(third.poses, third.points, o.cam_idx,
                               o.lm_idx, o.uv,
                               o.weight * robust.huber(2e-3).weight(s_))
    _, _, gp, gl, _ = schur._assemble(*lin, o.cam_idx, o.lm_idx, sc.n_cams,
                                      sc.n_points)
    gtol = 1.01 * float(torch.maximum(gp.abs().max(), gl.abs().max()))
    jseen, seen = [], []
    ref = jschur.solve_ba(jp0, jx0, jsc.obs, fixed_mask=jfx, max_iters=20,
                          loss=jrobust.huber(2e-3), gtol=gtol,
                          callback=lambda i, c, l: jseen.append(
                              (int(i), float(c), float(l))))
    out = schur.solve_ba(p0, x0, sc.obs, fixed_mask=fx, max_iters=20,
                         loss=robust.huber(2e-3), gtol=gtol,
                         callback=lambda i, c, l: seen.append(
                             (i, float(c), float(l))))
    assert out.it == int(ref.it) == 4
    assert [s[0] for s in seen] == [s[0] for s in jseen] == list(range(out.it))
    np.testing.assert_allclose([s[1] for s in seen], [s[1] for s in jseen],
                               rtol=1e-8)
    np.testing.assert_allclose([s[2] for s in seen], [s[2] for s in jseen],
                               rtol=1e-8)
    np.testing.assert_allclose(out.poses.t.numpy(), np.asarray(ref.poses.t),
                               rtol=0, atol=1e-8)


def test_solve_ba_value_errors():
    _, (sc, p0, x0, fx) = _problem()
    for solver in ("tracks", "paired", "cholesky"):
        with pytest.raises(ValueError):
            schur.solve_ba(p0, x0, sc.obs, fixed_mask=fx, max_iters=1,
                           linear_solver=solver)


def test_reprojection_residuals_match_jax():
    """residuals/reprojection.py, batched, against the JAX functions mapped
    with vmap: residuals, pixel residuals and the analytic Jacobians to
    1e-12 relative."""
    import jax

    from slam_tricks_tpu.manifolds import se3 as jse3
    from slam_tricks_tpu.residuals import camera as jcamera
    from slam_tricks_tpu.residuals import reprojection as jrep
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.residuals import camera, reprojection

    (jsc, jp0, jx0, _), (sc, p0, x0, _) = _problem()
    o, jo = sc.obs, jsc.obs
    cam, lm = o.cam_idx.long(), o.lm_idx.long()
    T = se3.SE3(p0.R[cam], p0.t[cam])
    jT = jse3.SE3(jp0.R[jo.cam_idx], jp0.t[jo.cam_idx])
    jpts = jx0[jo.lm_idx]
    r = reprojection.reproject_normalized(T, x0[lm], o.uv)
    jr = jax.vmap(jrep.reproject_normalized)(jT, jpts, jo.uv)
    assert rel_err(r, jr) < 1e-12
    intr = camera.Intrinsics(458.654, 457.296, 367.215, 248.375)
    jintr = jcamera.Intrinsics(*intr)
    px = o.uv * 400.0 + 300.0
    rp = reprojection.reproject_pixel(intr, T, x0[lm], px)
    jrp = jax.vmap(lambda t, p, u: jrep.reproject_pixel(jintr, t, p, u))(
        jT, jpts, jnp.asarray(px.numpy()))
    assert rel_err(rp, jrp) < 1e-12
    out = reprojection.reproject_normalized_jacobians(T, x0[lm])
    jout = jax.vmap(jrep.reproject_normalized_jacobians)(jT, jpts)
    for a, b in zip(out, jout):
        assert rel_err(a, b) < 1e-12


def test_lm_gain_update_matches_jax():
    """The LM control law from flat vectors, accepted and rejected, in f64:
    to 1e-12 relative."""
    rng = np.random.default_rng(4)
    d, g, diag = rng.random(30), -rng.random(30), rng.random(30)
    for cost_try, bad in ((0.5, False), (2.0, False), (0.5, True)):
        args = (1.0, cost_try, 1e-3, 2.0, d, g, diag, bad)
        ref = jschur.lm_gain_update(*(jnp.asarray(a) for a in args))
        out = schur.lm_gain_update(*(torch.as_tensor(np.asarray(a))
                                     for a in args))
        for a, r in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-12)
