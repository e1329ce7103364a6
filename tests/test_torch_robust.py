"""Robust losses: slam_tricks_tpu_torch/residuals/robust.py, and the loss=
of the linearize + assemble (its plain version) and of the two solvers,
against the JAX package's residuals/robust.py and solvers, in f64.

The same loss is built on both sides by name and parameter. Tolerances:
rho and weight to 1e-14 of the largest value (the same formulas); the
linearize + assemble with each loss to 1e-10 per output, as max |a - b| /
max |b| (tests/test_torch_ba_assemble.py: the same arithmetic summed in
another order); path A with huber(1.0), 10 iterations
(tests/test_schur_flat_sm.py:57-70), as tests/test_torch_schur_flat_sm.py
holds path A: the same iteration count and stop flag, cost rtol 1e-6 (atol
1e-20), poses and points to 1e-8 (on a scene with outliers: see the
path_a fixture); path B with huber(0.01), 6 iterations
(tests/test_banded_flat.py:98-112, on a K = 3 scene), as tests/test_torch_banded_flat.py holds
path B: cost rtol 1e-7 (atol 1e-20), rotations 1e-9, points 1e-8,
translations 1e-10 of their largest entry. Both scenes have pix_noise=1e-3,
so that the solves stop above the f64 noise floor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.residuals import robust as jrobust
from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import banded_flat as jbf
from slam_tricks_tpu.solvers import schur_flat_sm as jsm
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.ops import ba_assemble
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.solvers import banded_flat, schur_flat_sm
from tests.torch_util import rel_err

LOSSES = [("trivial", ()), ("huber", (1.0,)), ("huber", (0.01,)),
          ("cauchy", (1.0,)), ("cauchy", (0.3,)), ("tukey", (4.685,)),
          ("tukey", (0.02,)), ("chi2_gate", (0.5,))]


def _both(name, args):
    return getattr(jrobust, name)(*args), getattr(robust, name)(*args)


@pytest.mark.parametrize("name, args", LOSSES)
def test_rho_and_weight_match_jax(name, args):
    rng = np.random.default_rng(3)
    # squared norms across every threshold of the losses above, and 0
    s = np.concatenate([[0.0, 1e-4, 0.25, 0.5, 1.0, 21.95],
                        10.0 ** rng.uniform(-8, 2, 500)])
    jl, tl = _both(name, args)
    st = torch.as_tensor(s)
    for fn in ("rho", "weight"):
        a = getattr(tl, fn)(st).numpy()
        b = np.asarray(getattr(jl, fn)(jnp.asarray(s)))
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-14 * max(np.abs(b).max(), 1e-300),
                                   err_msg=fn)


@pytest.fixture(scope="module")
def path_a():
    """The 16-camera cube-room scene of the path-A tests, noisy, with one
    observation in 40 moved by N(0, 2) (normalized units) so that
    huber(1.0) bites; in both packages. Without the outliers huber(1.0) is
    quadratic on every residual and the tenth step lies at the f64 floor,
    where the stop decision flips (9 iterations against 10)."""
    kw = dict(n_per_wall=60, n_cams=16, seed=3, pix_noise=1e-3)
    jsc = jmake_scene(dtype=np.float64, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=4)
    rng = np.random.default_rng(5)
    uv = np.array(jsc.obs.uv)
    live = np.flatnonzero(np.asarray(jsc.obs.weight) > 0)
    hit = rng.choice(live, live.size // 40, replace=False)
    uv[hit] += rng.normal(scale=2.0, size=(hit.size, 2))
    obs = jsc.obs._replace(uv=jnp.asarray(uv))
    jwork = jsm.build_slot_work(obs, jsc.n_cams, jsc.n_points,
                                dtype=np.float64)
    work = interop.slot_work_from_jax(jwork, "cpu")
    port = (interop.poses_from_jax(jp0, "cpu"), interop.tensor(jx0, "cpu"),
            interop.tensor(jfx, "cpu"), work)
    return (jp0, jx0, jfx, jwork), port


@pytest.mark.parametrize("name, args", [("huber", (1.0,)), ("cauchy", (1.0,)),
                                        ("tukey", (0.02,)),
                                        ("chi2_gate", (1e-5,))])
def test_assemble_with_loss_matches_jax(path_a, name, args):
    """Huber and Cauchy scale the outliers down; Tukey(0.02) and the 1e-5
    gate give some live slots weight 0."""
    (jp0, jx0, _, jwork), (p0, x0, _, work) = path_a
    jl, tl = _both(name, args)
    ref = jsm._quantities_sm(jp0, jx0, jwork, loss=jl)
    ref = (ref[0], ref[1], jnp.stack(ref[2]), jnp.stack(ref[3]), ref[4],
           ref[5])
    out = ba_assemble.linearize_assemble(
        p0.R.reshape(work.n_cams, 9), p0.t, x0, work.uv0, work.uv1, work.w,
        work.cam_of_slot, loss=tl)
    for label, a, b in zip(("Hpp", "gp", "Hll", "gl", "W", "cost"), out, ref):
        assert a.shape == b.shape, label
        assert rel_err(a, b) < 1e-10, (label, rel_err(a, b))


def test_path_a_huber_matches_jax(path_a):
    (jp0, jx0, jfx, jwork), (p0, x0, fx, work) = path_a
    ref = jsm.solve_ba_flat_sm(jp0, jx0, jwork, fixed_mask=jfx, max_iters=10,
                               loss=jrobust.huber(1.0))
    out = schur_flat_sm.solve_ba_flat_sm(p0, x0, work, fixed_mask=fx,
                                         max_iters=10, loss=robust.huber(1.0))
    assert (out.it, out.done) == (int(ref.it), bool(ref.done))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6,
                               atol=1e-20)
    for a, b in ((out.poses.R, ref.poses.R), (out.poses.t, ref.poses.t),
                 (out.points, ref.points)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


def test_path_b_huber_matches_jax():
    """A 16-camera trajectory with tracks of 3 (K = 3): the JAX solve
    compiles in a third of the time of the K = 6 scene of
    tests/test_banded_flat.py, and the loss does not depend on K."""
    kw = dict(n_cams=16, n_points=300, track_len=3, seed=79, pix_noise=1e-3)
    jsc = jmake_trajectory(dtype=np.float64, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=80)
    jbw = jbf.build_banded_work(jsc.obs, jsc.n_cams, jsc.n_points,
                                dtype=np.float64)
    bw = interop.banded_work_from_jax(jbw, jsc.n_points, "cpu")
    ref = jbf.solve_ba_banded(jp0, jx0, jbw, fixed_mask=jfx, max_iters=6,
                              loss=jrobust.huber(0.01))
    out = banded_flat.solve_ba_banded(
        interop.poses_from_jax(jp0, "cpu"), interop.tensor(jx0, "cpu"), bw,
        fixed_mask=interop.tensor(jfx, "cpu"), max_iters=6,
        loss=robust.huber(0.01))
    assert (out.it, out.done) == (int(ref.it), bool(ref.done))
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-7,
                               atol=1e-20)
    np.testing.assert_allclose(out.poses.R.numpy(), np.asarray(ref.poses.R),
                               rtol=0, atol=1e-9)
    t_ref = np.asarray(ref.poses.t)
    np.testing.assert_allclose(out.poses.t.numpy(), t_ref, rtol=0,
                               atol=1e-10 * np.abs(t_ref).max())
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points),
                               rtol=0, atol=1e-8)


def test_loss_is_checked():
    with pytest.raises(ValueError):
        robust.Loss("welsch", 1.0).rho(torch.ones(2))
    with pytest.raises(TypeError):
        robust.check(robust.Loss("welsch", 1.0))
    robust.check(None)
    robust.check(robust.tukey())
