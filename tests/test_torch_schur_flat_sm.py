"""The whole slice, slam_tricks_tpu_torch/solvers/schur_flat_sm.py, against
the JAX package's solve_ba_flat_sm on the 16-camera scene of
tests/test_schur_flat_sm.py, in f64.

Both run the same control law on the same numbers, so the iteration count
is equal and cost and poses agree to rtol 1e-6 and 1e-8 (f64 summation
order only; not the reference's own loose 0.3). On the noiseless scene
both converge to the f64 floor (~2e-29), where relative cost parity means
nothing, so the cost also gets atol 1e-20; the noisy variant keeps a real
residual (1.5e-3) and stops before that floor."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import schur as jschur
from slam_tricks_tpu.solvers import schur_flat_sm as jsm
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.ops.ba_assemble import linearize_assemble_plain
from slam_tricks_tpu_torch.sim import make_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import schur, schur_flat_sm
from tests.torch_util import rel_err

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problems(pix_noise=0.0, dtype=np.float64):
    """The same scene built by both packages."""
    kw = dict(n_per_wall=60, n_cams=16, seed=3, pix_noise=pix_noise)
    jsc = jmake_scene(dtype=dtype, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=4)
    jwork = jsm.build_slot_work(jsc.obs, jsc.n_cams, jsc.n_points, dtype=dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    sc = make_scene(dtype=tdt, device="cpu", **kw)
    p0, x0, fx = perturb_scene(sc, seed=4)
    work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                         dtype=tdt)
    return (jsc, jp0, jx0, jfx, jwork), (sc, p0, x0, fx, work)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_slot_work_and_interop_match(dtype):
    (jsc, jp0, jx0, _, jwork), (sc, p0, x0, _, work) = _problems(dtype=dtype)
    conv = interop.slot_work_from_jax(jwork, "cpu")
    assert conv.n_cams == work.n_cams == jwork.n_cams
    for name in ("uv0", "uv1", "w", "mask", "cam_of_slot"):
        ref = np.asarray(getattr(jwork, name))
        np.testing.assert_array_equal(getattr(work, name).numpy(), ref, name)
        np.testing.assert_array_equal(getattr(conv, name).numpy(), ref, name)
    # interop round trips: JAX arrays -> tensors -> numpy, unchanged
    for a, b in zip(interop.obs_from_jax(jsc.obs, "cpu"), sc.obs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    poses = interop.poses_from_jax(jp0, "cpu")
    np.testing.assert_array_equal(poses.R.numpy(), np.asarray(jp0.R))
    np.testing.assert_array_equal(poses.t.numpy(), np.asarray(jp0.t))
    np.testing.assert_array_equal(interop.tensor(jx0, "cpu").numpy(),
                                  np.asarray(jx0))
    # the track table under the slot grid
    jt = jschur.build_track_table(jsc.obs.cam_idx, jsc.obs.lm_idx,
                                  jsc.obs.weight, n_points=jsc.n_points)
    t = schur.build_track_table(sc.obs.cam_idx.numpy(), sc.obs.lm_idx.numpy(),
                                sc.obs.weight.numpy(), n_points=sc.n_points)
    np.testing.assert_array_equal(t.obs_idx, np.asarray(jt.obs_idx))
    np.testing.assert_array_equal(t.mask, np.asarray(jt.mask))


def test_first_step_matches_jax():
    """dp, dl of the first damped Schur solve, from identical blocks."""
    (_, jp0, jx0, jfx, jwork), (_, p0, x0, fx, work) = _problems()
    C = work.n_cams
    jb = jsm._quantities_sm(jp0, jx0, jwork)
    lam = 1e-4
    ref = jsm._solve_sm(jb[0], jb[1], list(jb[2]), list(jb[3]), jb[4],
                        jnp.asarray(lam), jfx, jwork)
    Hpp, gp, Hll, gl, W, _ = linearize_assemble_plain(
        p0.R.reshape(C, 9), p0.t, x0, work.uv0, work.uv1, work.w,
        work.cam_of_slot)
    out = schur_flat_sm._solve_sm(Hpp, gp, Hll, gl, W,
                                  torch.tensor(lam, dtype=torch.float64), fx,
                                  work)
    for name, a, b in zip(("dp", "dl", "diag_pp", "diag_ll"), out, ref):
        assert a.shape == b.shape, name
        assert rel_err(a, b) < 1e-8, (name, rel_err(a, b))


@pytest.mark.parametrize("pix_noise, max_iters", [(0.0, 15), (1e-3, 6)])
def test_solve_matches_jax(pix_noise, max_iters):
    (_, jp0, jx0, jfx, jwork), (_, p0, x0, fx, work) = _problems(pix_noise)
    ref = jsm.solve_ba_flat_sm(jp0, jx0, jwork, fixed_mask=jfx,
                               max_iters=max_iters)
    costs = []
    out = schur_flat_sm.solve_ba_flat_sm(p0, x0, work, fixed_mask=fx,
                                         max_iters=max_iters, costs=costs)
    assert out.it == int(ref.it)
    assert out.done == bool(ref.done)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-6,
                               atol=1e-20)
    np.testing.assert_allclose(out.poses.R.numpy(), np.asarray(ref.poses.R),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.poses.t.numpy(), np.asarray(ref.poses.t),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points),
                               rtol=0, atol=1e-8)
    c = [float(x) for x in costs]
    assert len(c) == out.it + 1 and all(b <= a for a, b in zip(c, c[1:]))


def test_robust_loss_not_ported():
    """The JAX package's Loss, a pair of closures, is not ported as such:
    the solver takes the port's Loss (a name and a parameter, which the
    kernel can take) and refuses the JAX one, or any other object."""
    from slam_tricks_tpu.residuals import robust as jrobust

    _, (_, p0, x0, fx, work) = _problems()
    for loss in (jrobust.huber(1.0), object()):
        with pytest.raises(TypeError):
            schur_flat_sm.solve_ba_flat_sm(p0, x0, work, fixed_mask=fx,
                                           loss=loss)


def test_import_leaves_jax_out():
    code = ("import sys, slam_tricks_tpu_torch.interop, "
            "slam_tricks_tpu_torch.solvers, slam_tricks_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'slam_tricks_tpu']; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr



def test_large_c_matches_jax_gather_branch():
    """C > 128, where the JAX package's build_slot_work switches to its
    camera gather table (use_onehot=False): the port, which gathers at
    every C and takes use_onehot= for the JAX call shape, against that
    branch, f64: the first step to 1e-8 relative and 3 LM iterations as in
    test_solve_matches_jax."""
    kw = dict(n_per_wall=30, n_cams=136, seed=5, pix_noise=1e-3)
    jsc = jmake_scene(dtype=np.float64, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, 0.002, 0.01, 0.01, seed=6)
    jwork = jsm.build_slot_work(jsc.obs, jsc.n_cams, jsc.n_points,
                                dtype=np.float64, use_onehot=False)
    assert jwork.cam_table is not None
    sc = make_scene(dtype=torch.float64, device="cpu", **kw)
    p0, x0, fx = perturb_scene(sc, 0.002, 0.01, 0.01, seed=6)
    work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                         dtype=torch.float64,
                                         use_onehot=False)
    C = work.n_cams
    jb = jsm._quantities_sm(jp0, jx0, jwork)
    ref = jsm._solve_sm(jb[0], jb[1], list(jb[2]), list(jb[3]), jb[4],
                        jnp.asarray(1e-4), jfx, jwork)
    Hpp, gp, Hll, gl, W, _ = linearize_assemble_plain(
        p0.R.reshape(C, 9), p0.t, x0, work.uv0, work.uv1, work.w,
        work.cam_of_slot)
    out = schur_flat_sm._solve_sm(Hpp, gp, Hll, gl, W,
                                  torch.tensor(1e-4, dtype=torch.float64),
                                  fx, work)
    for name, a, b in zip(("dp", "dl"), out, ref):
        assert rel_err(a, b) < 1e-8, (name, rel_err(a, b))
    jfinal = jsm.solve_ba_flat_sm(jp0, jx0, jwork, fixed_mask=jfx,
                                  max_iters=3)
    final = schur_flat_sm.solve_ba_flat_sm(p0, x0, work, fixed_mask=fx,
                                           max_iters=3)
    assert final.it == int(jfinal.it)
    np.testing.assert_allclose(float(final.cost), float(jfinal.cost),
                               rtol=1e-6)
    np.testing.assert_allclose(final.poses.t.numpy(),
                               np.asarray(jfinal.poses.t), rtol=0, atol=1e-8)
