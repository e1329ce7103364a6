"""The stored block-tridiagonal factor and the banded covariances of
slam_tricks_tpu_torch/solvers/banded_flat.py against the JAX package's
solvers/banded_flat.py, in f64.

The factor (block_tridiag_factor), its extension from a super-block g0
(block_tridiag_factor_extend, g0 in {0, 1, 5, 11, G + 3}, after the blocks
[g0:] changed, as tests/test_incremental.py:24-46 builds them) and both
substitutions with one right-hand side and with q = 3 agree to 1e-12 (the
same block Cholesky; the JAX substitutions are an associative scan, the
port's a loop). The pose and landmark covariances (banded_pose_covariances,
banded_covariances) agree to 1e-10 of their largest entry on a noisy
16-camera trajectory with tracks of 4, at lam=1e-3: with lam near 0 the
circle's weakly held scale makes the covariances ~3e7 and the two agree
only to ~1e-8, the conditioning."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu.solvers import banded_flat as jbf
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.solvers import banded_flat
import tests.torch_util  # noqa: F401  (caps torch's threads)

G, M = 12, 6


def _spd_tridiag(seed=0):
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(G, M, M))
    D = D @ D.transpose(0, 2, 1) + 4 * M * np.eye(M)[None]
    E = 0.1 * rng.normal(size=(G - 1, M, M))
    return D, E


def _changed(D, E, g0):
    """The blocks [g0:] and couplings E[g0 - 1:] changed, the rest kept."""
    D2, E2 = D.copy(), E.copy()
    D2[g0:] += 0.05
    D2[g0:] = 0.5 * (D2[g0:] + D2[g0:].transpose(0, 2, 1))
    E2[max(g0 - 1, 0):] += 0.01
    return D2, E2


def _close(a, b, tol=1e-12):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


def test_factor_matches_jax():
    D, E = _spd_tridiag()
    ref = jbf.block_tridiag_factor(jnp.asarray(D), jnp.asarray(E))
    fac = banded_flat.block_tridiag_factor(torch.as_tensor(D),
                                           torch.as_tensor(E))
    assert fac.L.shape == (G, M, M) and fac.F.shape == (G - 1, M, M)
    _close(fac.L, ref.L)
    _close(fac.F, ref.F)


@pytest.mark.parametrize("g0", [0, 1, 5, 11, G + 3])
def test_factor_extend_matches_jax(g0):
    D, E = _spd_tridiag()
    fac0 = banded_flat.block_tridiag_factor(torch.as_tensor(D),
                                            torch.as_tensor(E))
    jfac0 = jbf.block_tridiag_factor(jnp.asarray(D), jnp.asarray(E))
    D2, E2 = (D, E) if g0 >= G else _changed(D, E, g0)
    ext = banded_flat.block_tridiag_factor_extend(
        fac0, torch.as_tensor(D2), torch.as_tensor(E2), g0)
    ref = jbf.block_tridiag_factor_extend(jfac0, jnp.asarray(D2),
                                          jnp.asarray(E2), g0)
    scratch = banded_flat.block_tridiag_factor(torch.as_tensor(D2),
                                               torch.as_tensor(E2))
    for a, b, c in ((ext.L, ref.L, scratch.L), (ext.F, ref.F, scratch.F)):
        _close(a, b)
        _close(a, c.numpy())


@pytest.mark.parametrize("q", [None, 3])
def test_substitutions_match_jax(q):
    D, E = _spd_tridiag(1)
    rng = np.random.default_rng(2)
    R = rng.normal(size=(G, M) if q is None else (G, M, q))
    fac = banded_flat.block_tridiag_factor(torch.as_tensor(D),
                                           torch.as_tensor(E))
    jfac = jbf.block_tridiag_factor(jnp.asarray(D), jnp.asarray(E))
    y = banded_flat.tridiag_forward(fac, torch.as_tensor(R))
    x = banded_flat.tridiag_backward(fac, y)
    jy = jbf.tridiag_forward(jfac, jnp.asarray(R))
    _close(y, jy)
    _close(x, jbf.tridiag_backward(jfac, jy))
    # and x solves the block-tridiagonal system
    T = np.zeros((G, M, G, M))
    for g in range(G):
        T[g, :, g] = D[g]
    for g in range(G - 1):
        T[g + 1, :, g] = E[g]
        T[g, :, g + 1] = E[g].T
    xr = np.linalg.solve(T.reshape(G * M, G * M), R.reshape(G * M, -1))
    np.testing.assert_allclose(x.numpy().reshape(G * M, -1), xr, rtol=0,
                               atol=1e-12)


@pytest.fixture(scope="module")
def trajectory():
    jsc = jmake_trajectory(n_cams=16, n_points=300, track_len=4, seed=79,
                           pix_noise=1e-3, dtype=np.float64)
    jp0, jx0, jfx = jperturb_scene(jsc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=80)
    jbw = jbf.build_banded_work(jsc.obs, jsc.n_cams, jsc.n_points,
                                dtype=np.float64)
    port = (interop.poses_from_jax(jp0, "cpu"), interop.tensor(jx0, "cpu"),
            interop.banded_work_from_jax(jbw, jsc.n_points, "cpu"),
            interop.tensor(jfx, "cpu"))
    return (jp0, jx0, jbw, jfx), port


def test_banded_covariances_match_jax(trajectory):
    jargs, args = trajectory
    ref_p, ref_l = jbf.banded_covariances(*jargs, lam=1e-3,
                                          compute_landmarks=True)
    pose, point = banded_flat.banded_covariances(*args, lam=1e-3,
                                                 compute_landmarks=True)
    for a, b in ((pose, ref_p), (point, ref_l)):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * np.abs(b).max())


def test_banded_pose_covariances_match_jax(trajectory):
    jargs, args = trajectory
    ref = np.asarray(jbf.banded_pose_covariances(*jargs, lam=1e-3))
    got = banded_flat.banded_pose_covariances(*args, lam=1e-3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())
    assert not got[args[3]].any()          # fixed cameras get zero
