"""slam_tricks_tpu_torch/solvers/covariance.py against the JAX package's
ba_covariances, and against the port's own banded covariances, in f64.

Tolerances: against JAX, on the same converged state of the 6-camera scene
of tests/test_covariance_triangulation.py, pose and landmark marginals to
1e-9 of the largest entry (both invert the same S; the sums run in another
order); the pose blocks symmetric to 1e-10 of their largest entry (the
inverse of S is symmetric up to rounding). Against
banded_flat.banded_covariances on a trajectory, the JAX package's own
cross-check bounds (tests/test_banded_flat.py): poses rtol 1e-5 and atol
1e-8 of the largest entry, landmarks rtol 1e-4 and atol 1e-7."""

import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import schur as jschur
from slam_tricks_tpu.solvers.covariance import \
    ba_covariances as jba_covariances
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.sim import make_trajectory_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import banded_flat
from slam_tricks_tpu_torch.solvers.covariance import ba_covariances
import tests.torch_util  # noqa: F401  (caps torch's threads)

f64 = torch.float64


@pytest.mark.parametrize("lam", [0.0, 1e-6])
def test_ba_covariances_match_jax(lam):
    sc = jmake_scene(n_per_wall=10, n_cams=6, seed=63, dtype=np.float64)
    p0, x0, fixed = jperturb_scene(sc, seed=64)
    final = jschur.solve_ba(p0, x0, sc.obs, fixed_mask=fixed, max_iters=30)
    jpc, jlc = jba_covariances(final.poses, final.points, sc.obs, fixed,
                               lam=lam, compute_landmarks=True)
    poses = interop.poses_from_jax(final.poses, "cpu")
    points = interop.tensor(final.points, "cpu")
    obs = interop.obs_from_jax(sc.obs, "cpu")
    fx = interop.tensor(fixed, "cpu")
    pc, lc = ba_covariances(poses, points, obs, fx, lam=lam,
                            compute_landmarks=True)
    for got, ref in ((pc, jpc), (lc, jlc)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-9 * np.abs(ref).max())
    pc_only, none = ba_covariances(poses, points, obs, fx, lam=lam)
    assert none is None and torch.equal(pc_only, pc)
    # fixed cameras zero, the free ones symmetric positive definite
    assert float(pc[fx].abs().max()) == 0.0
    for c in torch.nonzero(~fx).squeeze(1):
        assert torch.allclose(pc[c], pc[c].T, rtol=0,
                              atol=1e-10 * float(pc[c].abs().max()))
        assert float(torch.linalg.eigvalsh(pc[c]).min()) > 0


def test_ba_covariances_match_banded_covariances():
    sc = make_trajectory_scene(n_cams=20, n_points=250, track_len=5, seed=85,
                               dtype=f64, device="cpu")
    p0, x0, fixed = perturb_scene(sc, pose_rot_noise=0.002,
                                  pose_trans_noise=0.01, point_noise=0.01,
                                  seed=86)
    bw = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                       dtype=f64)
    out = banded_flat.solve_ba_banded(p0, x0, bw, fixed_mask=fixed,
                                      max_iters=15)
    dpc, dlc = ba_covariances(out.poses, out.points, sc.obs, fixed, lam=1e-8,
                              compute_landmarks=True)
    bpc, blc = banded_flat.banded_covariances(out.poses, out.points, bw,
                                              fixed, lam=1e-8,
                                              compute_landmarks=True)
    ps = float(dpc.abs().max())
    np.testing.assert_allclose(bpc.numpy(), dpc.numpy(), atol=1e-8 * ps,
                               rtol=1e-5)
    w, lm = sc.obs.weight.numpy(), sc.obs.lm_idx.numpy()
    observed = np.zeros(sc.n_points, bool)
    observed[lm[w > 0]] = True
    ls = float(np.abs(dlc.numpy()[observed]).max())
    np.testing.assert_allclose(blc.numpy()[observed], dlc.numpy()[observed],
                               atol=1e-7 * ls, rtol=1e-4)
