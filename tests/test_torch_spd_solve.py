"""SPD solve of the reduced camera system (slam_tricks_tpu_torch/ops/
spd_solve.py).

The plain torch version is held against the Pallas kernel it replaces,
``pallas_chol.chol_solve`` in interpret mode, on random SPD matrices and on
the damped, gauge-fixed S of a small BA problem. The CUDA kernel is held
against the plain version in test_torch_cuda.py.

Tolerance 5e-6 as max |x - x_ref| / max |x_ref|, the bound
``tests/test_pallas_chol.py`` holds the Pallas kernel to against LAPACK:
two f32 Cholesky solves of well-conditioned systems."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.ops.pallas_chol import chol_solve
from slam_tricks_tpu_torch.ops import spd_solve as spd
from slam_tricks_tpu_torch.sim import make_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import schur_flat_sm
from tests.torch_util import rel_err


def _spd(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    S = A @ A.T + n * np.eye(n)
    b = rng.normal(size=n)
    return S.astype(dtype), b.astype(dtype)


def _ba_system():
    """S, b of the first LM step (lam 1e-4) on the scene of
    tests/test_pallas_chol.py::test_ba_reduced_system_shape (f32)."""
    sc = make_scene(n_per_wall=10, n_cams=6, seed=21, dtype=torch.float32,
                    device="cpu")
    poses0, points0, fixed = perturb_scene(sc, seed=22)
    work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                         dtype=torch.float32)
    blocks, _ = schur_flat_sm._quantities_sm(poses0, points0, work)
    lam = torch.tensor(1e-4, dtype=torch.float32)
    S, b, *_ = schur_flat_sm.reduced_camera_system(*blocks, lam, fixed, work)
    return S, b


@pytest.mark.parametrize("n", [64, 200])
def test_plain_matches_pallas_interpret(n):
    S, b = _spd(n, seed=n)
    ref = chol_solve(jnp.asarray(S), jnp.asarray(b), interpret=True)
    x = spd.spd_solve(torch.as_tensor(S), torch.as_tensor(b))
    assert rel_err(x, ref) < 5e-6


def test_plain_matches_pallas_on_ba_system():
    S, b = _ba_system()
    assert S.shape == (36, 36)
    ref = chol_solve(jnp.asarray(S.numpy()), jnp.asarray(b.numpy()),
                     interpret=True)
    x = spd.spd_solve(S, b)
    assert rel_err(x, ref) < 5e-6


def test_plain_flags_non_spd():
    """The plain version turns a failed factorization into NaN, which the
    solver's bad-step branch zeroes."""
    S = torch.diag(torch.tensor([1.0, -1.0, 2.0]))
    x = spd.spd_solve(S, torch.ones(3))
    assert not torch.isfinite(x).any()



def test_size_limit():
    """The kernel takes 1 <= n <= 46340 (n * n < 2**31, its element
    offsets being 32-bit ints); shared memory no longer bounds n."""
    spd.check_size(1)
    spd.check_size(spd.MAX_N)
    assert spd.MAX_N ** 2 < 2 ** 31 <= (spd.MAX_N + 1) ** 2
    for n in (0, spd.MAX_N + 1):
        with pytest.raises(ValueError, match="outside"):
            spd.check_size(n)


def test_path_rule():
    """The kernel is chosen by n alone. Every n <= 672 the port's solvers
    use (st20's 180, the distributed solvers' 576, the pose graphs' 240 and
    672, the VI window's 144, K64's 582, N's 294, the examples' 12 to 672)
    takes spd_solve.cu; BAL Dubrovnik's 3,204 and paths D and G's 6,144
    take spd_solve_blocked.cu, as does every n from the crossover on."""
    assert 672 < spd.BLOCKED_MIN_N <= 3204
    assert not any(spd.blocked_path(n) for n in range(1, 673))
    assert not spd.blocked_path(spd.BLOCKED_MIN_N - 1)
    for n in (spd.BLOCKED_MIN_N, 3204, 6144, spd.MAX_N):
        assert spd.blocked_path(n)
