"""The banded trajectory solve, slam_tricks_tpu_torch/solvers/banded_flat.py,
against the JAX package's solvers/banded_flat.py on the scene of
tests/test_banded_flat.py (32 cameras, 600 landmarks, tracks of 6, seed 71,
f64), a K = 2 scene and a one-super-block (G = 1) scene; the layout also
on the widest band the layout takes, K = 32 (512 cameras, tracks of 32).

The layout is built by the same numpy steps, so it is equal. The JAX solve
reaches the block-tridiagonal system through batched cyclic reduction, the
port through the Pallas recursion's plain version: both are exact solves,
so one step agrees to 1e-9 and a 6-iteration solve has the same iteration
count, cost to rtol 1e-7, rotations to 1e-9, points to 1e-8 and
translations to 1e-10 of their largest entry (|t| ~ 50, so 5e-9): the first
and last cameras that fix the gauge are neighbours on the circle, the scale
is weakly held, and the JAX solve's own translations move by 1e-9 between
one and eight BLAS threads. The noiseless solves end near the f64 floor, so
the cost also gets atol 1e-20."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import banded_flat as jbf
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.sim import make_scene, make_trajectory_scene
from slam_tricks_tpu_torch.solvers import banded_flat
import tests.torch_util  # noqa: F401  (caps torch's threads)

SCENES = {   # n_cams, n_points, track_len, seed
    "default": (32, 600, 6, 71),
    "k2": (24, 400, 2, 79),
    "g1": (6, 200, 6, 81),
}
WIDE = {"k32": (512, 600, 32, 83)}   # layout only: the JAX solve compiles for minutes


def _problems(name):
    """The same problem in both packages; the port's state through interop,
    its layout built by its own build_banded_work."""
    n_cams, n_points, track_len, seed = {**SCENES, **WIDE}[name]
    kw = dict(n_cams=n_cams, n_points=n_points, track_len=track_len,
              seed=seed)
    jsc = jmake_trajectory(dtype=np.float64, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=seed + 1)
    jbw = jbf.build_banded_work(jsc.obs, jsc.n_cams, jsc.n_points,
                                dtype=np.float64)
    sc = make_trajectory_scene(dtype=torch.float64, device="cpu", **kw)
    bw = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                       dtype=torch.float64)
    port = (interop.poses_from_jax(jp0, "cpu"), interop.tensor(jx0, "cpu"),
            interop.tensor(jfx, "cpu"), bw)
    return (jsc, jp0, jx0, jfx, jbw), port


@pytest.mark.parametrize("name", sorted(SCENES) + sorted(WIDE))
def test_layout_matches_jax(name):
    (jsc, _, _, _, jbw), (_, _, _, bw) = _problems(name)
    conv = interop.banded_work_from_jax(jbw, jsc.n_points, "cpu")
    uv = np.asarray(jbw.uv)
    c0 = np.argmax(np.asarray(jbw.onehot), axis=1)
    for work in (bw, conv):
        assert (work.n_cams, work.n_points) == (jsc.n_cams, jsc.n_points)
        np.testing.assert_array_equal(work.uv0.numpy(), uv[:, 0])
        np.testing.assert_array_equal(work.uv1.numpy(), uv[:, 1])
        np.testing.assert_array_equal(work.w.numpy(), np.asarray(jbw.weight))
        np.testing.assert_array_equal(work.c0.numpy(), c0)
        np.testing.assert_array_equal(work.scatter_idx.numpy(),
                                      np.asarray(jbw.scatter_idx))
        np.testing.assert_array_equal(work.gather_idx.numpy(),
                                      np.asarray(jbw.gather_idx))
    np.testing.assert_array_equal(bw.cam_of_slot.numpy(),
                                  conv.cam_of_slot.numpy())
    assert int(bw.cam_of_slot.max()) < jsc.n_cams
    assert bw.chunk == 32


def test_quantities_match_jax():
    (jsc, jp0, jx0, _, jbw), (p0, x0, _, bw) = _problems("default")
    ref = jbf._banded_quantities(jp0, jx0[jbw.gather_idx], jbw, jsc.n_cams)
    (Hpp, gp, Hll, gl, W), cost = banded_flat._banded_quantities(
        p0, x0[bw.gather_idx], bw)
    np.testing.assert_allclose(float(cost), float(ref[5]), rtol=1e-12)
    np.testing.assert_allclose(Hpp.numpy(), np.asarray(ref[0]), atol=1e-10)
    np.testing.assert_allclose(gp.numpy(), np.asarray(ref[1]), atol=1e-10)
    np.testing.assert_allclose(Hll.numpy(), np.stack(ref[2]), atol=1e-10)
    np.testing.assert_allclose(gl.numpy(), np.asarray(ref[3]), atol=1e-10)
    np.testing.assert_allclose(W.permute(1, 0, 2).numpy(), np.asarray(ref[4]),
                               atol=1e-10)


@pytest.mark.parametrize("name", ["default", "g1"])
def test_step_matches_jax(name):
    """One damped solve from the same blocks: dp and dl to 1e-9."""
    (jsc, jp0, jx0, jfx, jbw), (p0, x0, fx, bw) = _problems(name)
    C = jsc.n_cams
    jb = jbf._banded_quantities(jp0, jx0[jbw.gather_idx], jbw, C)
    lam = 1e-4
    ref = jbf._solve_banded(jb[0], jb[1], list(jb[2]), jb[3], jb[4],
                            jnp.asarray(lam), jfx, jbw, C)
    blocks, _ = banded_flat._banded_quantities(p0, x0[bw.gather_idx], bw)
    out = banded_flat._solve_banded(
        *blocks, torch.tensor(lam, dtype=torch.float64), fx, bw)
    for label, a, b in zip(("dp", "dl", "diag_pp", "diag_ll"), out, ref):
        assert tuple(a.shape) == tuple(b.shape), label
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9,
                                   err_msg=label)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_solve_matches_jax(name):
    (_, jp0, jx0, jfx, jbw), (p0, x0, fx, bw) = _problems(name)
    ref = jbf.solve_ba_banded(jp0, jx0, jbw, fixed_mask=jfx, max_iters=6)
    costs = []
    out = banded_flat.solve_ba_banded(p0, x0, bw, fixed_mask=fx, max_iters=6,
                                      costs=costs)
    assert out.it == int(ref.it)
    assert out.done == bool(ref.done)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-7,
                               atol=1e-20)
    np.testing.assert_allclose(out.poses.R.numpy(), np.asarray(ref.poses.R),
                               rtol=0, atol=1e-9)
    t_ref = np.asarray(ref.poses.t)
    np.testing.assert_allclose(out.poses.t.numpy(), t_ref, rtol=0,
                               atol=1e-10 * np.abs(t_ref).max())
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points),
                               rtol=0, atol=1e-8)
    c = [float(v) for v in costs]
    assert len(c) == out.it + 1 and all(b <= a for a, b in zip(c, c[1:]))


def test_robust_loss_not_ported():
    """The JAX package's Loss, a pair of closures, is not ported as such:
    the solver takes the port's Loss (a name and a parameter, which the
    kernel can take) and refuses the JAX one, or any other object."""
    from slam_tricks_tpu.residuals import robust as jrobust

    _, (p0, x0, fx, bw) = _problems("g1")
    for loss in (jrobust.huber(1.0), object()):
        with pytest.raises(TypeError):
            banded_flat.solve_ba_banded(p0, x0, bw, fixed_mask=fx, loss=loss)


def test_rejects_wide_band():
    scene = make_scene(n_per_wall=10, n_cams=6, seed=5, device="cpu")
    with pytest.raises(ValueError):
        banded_flat.build_banded_work(scene.obs, scene.n_cams, scene.n_points,
                                      max_band=3)
