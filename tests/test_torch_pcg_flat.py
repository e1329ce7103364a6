"""slam_tricks_tpu_torch/solvers/pcg_flat.py against the JAX package's
pcg_flat on the 32-camera trajectory scene of tests/test_pcg_flat.py, in
f64.

The port's tables name slots of the flat work's grid where the JAX
package's name observations; both name the same observations. Tolerances:
the PCG step to the JAX package's PCG step and to the exact dense step at
atol 1e-8 (tests/test_pcg.py's bound); a whole solve (pix_noise 1e-3) in
the iteration count, the cost to rtol 1e-8 and the state to 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import pcg_flat as jpcg_flat
from slam_tricks_tpu.solvers import schur_flat as jflat
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.sim import make_trajectory_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import pcg_flat, schur_flat
import tests.torch_util  # noqa: F401  (caps torch's threads)

f64 = torch.float64
PERTURB = dict(pose_rot_noise=0.002, pose_trans_noise=0.01, point_noise=0.01)


def _prob(pix_noise=0.0):
    kw = dict(n_cams=32, n_points=500, track_len=6, seed=2,
              pix_noise=pix_noise)
    jsc = jmake_trajectory(dtype=np.float64, **kw)
    jp0, jx0, jfx = jperturb_scene(jsc, seed=3, **PERTURB)
    sc = make_trajectory_scene(dtype=f64, device="cpu", **kw)
    p0, x0, fx = perturb_scene(sc, seed=3, **PERTURB)
    C, L = sc.n_cams, sc.n_points
    jwork = jflat.build_flat_work(jsc.obs, C, L, dtype=np.float64)
    jpw = jpcg_flat.build_pcg_work(jsc.obs, C, dtype=np.float64)
    work = schur_flat.build_flat_work(sc.obs, C, L, dtype=f64)
    pw = pcg_flat.build_pcg_work(sc.obs, C, dtype=f64, n_points=L)
    return dict(jsc=jsc, jp0=jp0, jx0=jx0, jfx=jfx, jwork=jwork, jpw=jpw,
                sc=sc, p0=p0, x0=x0, fx=fx, work=work, pw=pw, C=C, L=L)


@pytest.fixture(scope="module")
def prob():
    return _prob()


def test_pcg_work_tables(prob):
    p = prob
    obs, work, pw = p["sc"].obs, p["work"], p["pw"]
    conv = interop.pcg_work_from_jax(p["jpw"], p["jwork"], "cpu")
    for name in pcg_flat.PCGWork._fields[:-1]:
        np.testing.assert_array_equal(getattr(pw, name).numpy(),
                                      getattr(conv, name).numpy(), name)
    assert pw.n_points == conv.n_points == p["L"]
    # the same observations as the JAX package's tables, named by slot
    slot = work.obs_slot.numpy()
    jm = np.asarray(p["jpw"].cam_mask) > 0
    np.testing.assert_array_equal(pw.cam_table.numpy()[jm],
                                  slot[np.asarray(p["jpw"].cam_table)[jm]])
    assert float(pw.cam_mask.sum()) == float(obs.weight.sum())
    # every adjacency pair: one landmark, cameras c + 1 and c
    m = pw.adj_mask > 0
    a, b = pw.adj_a[m], pw.adj_b[m]
    L = p["L"]
    np.testing.assert_array_equal((a % L).numpy(), (b % L).numpy())
    cam = work.slot.cam_of_slot.reshape(-1).long()
    rows = torch.nonzero(m)[:, 0]
    np.testing.assert_array_equal(cam[a].numpy(), rows.numpy() + 1)
    np.testing.assert_array_equal(cam[b].numpy(), rows.numpy())


def test_pcg_flat_step_matches_jax_and_dense(prob):
    p = prob
    C, L = p["C"], p["L"]
    jq = jflat._iteration_quantities(p["jp0"], p["jx0"], p["jsc"].obs,
                                     p["jwork"], C, L)
    lam = 1e-4
    jdp, jdl, _, _ = jpcg_flat.solve_rcs_pcg_flat(
        jq[0], jq[1], list(jq[2]), jq[3], jq[4], p["jsc"].obs.lm_idx,
        jnp.asarray(lam), p["jfx"], p["jwork"], p["jpw"], C, L,
        cg_iters=200, cg_tol=1e-13)
    q = schur_flat._iteration_quantities(p["p0"], p["x0"], p["work"])
    lam_t = torch.tensor(lam, dtype=f64)
    dp, dl, dpp, dll = pcg_flat.solve_rcs_pcg_flat(
        *q[:5], lam_t, p["fx"], p["work"], p["pw"], cg_iters=200,
        cg_tol=1e-13)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), atol=1e-8)
    np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), atol=1e-8)
    ddp, ddl, ddpp, ddll = schur_flat._solve_flat(*q[:5], lam_t, p["fx"],
                                                  p["work"])
    np.testing.assert_allclose(dp.numpy(), ddp.numpy(), atol=1e-8)
    np.testing.assert_allclose(dl.numpy(), ddl.numpy(), atol=1e-8)
    assert torch.equal(dpp, ddpp) and torch.equal(dll, ddll)


def test_pcg_flat_solve_matches_jax():
    """With pix_noise 1e-3, so that both stop above the noise floor (where
    the noiseless scene's cost is CG rounding), and enough CG iterations
    that every step converges: with 100, CG stops short from the third step
    on and the weak gauge of the trajectory lets the two drift apart."""
    p = _prob(pix_noise=1e-3)
    ref = jflat.solve_ba_flat(p["jp0"], p["jx0"], p["jsc"].obs, p["jwork"],
                              fixed_mask=p["jfx"], max_iters=8, linear="pcg",
                              pcg_work=p["jpw"], cg_iters=400, cg_tol=1e-10)
    out = schur_flat.solve_ba_flat(p["p0"], p["x0"], p["sc"].obs, p["work"],
                                   fixed_mask=p["fx"], max_iters=8,
                                   linear="pcg", pcg_work=p["pw"],
                                   cg_iters=400, cg_tol=1e-10)
    assert out.it == int(ref.it)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-8)
    for a, r in ((out.poses.R, ref.poses.R), (out.poses.t, ref.poses.t),
                 (out.points, ref.points)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)
    rms = np.sqrt(float(out.cost) / float(p["sc"].obs.weight.sum()))
    assert rms < 2e-3, rms


def test_pcg_work_of_another_grid_is_refused(prob):
    p = prob
    other = pcg_flat.build_pcg_work(p["sc"].obs, p["C"], dtype=f64,
                                    n_points=p["L"] + 1)
    with pytest.raises(ValueError, match="landmarks"):
        schur_flat.solve_ba_flat(p["p0"], p["x0"], p["sc"].obs, p["work"],
                                 linear="pcg", pcg_work=other)
