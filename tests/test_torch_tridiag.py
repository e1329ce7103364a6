"""SPD block-tridiagonal solve (slam_tricks_tpu_torch/ops/tridiag_solve.py).

The plain torch version, which the wrapper runs on a CPU tensor and which
repeats the CUDA kernel's block cyclic reduction, is held against the
Pallas kernel it replaces, ``pallas_tridiag.tridiag_solve`` in interpret
mode, and against a dense f64 solve, with the cases and bounds of
tests/test_pallas_tridiag.py: (12, 16) f64 to 1e-9; (16, 48) f32 to 1e-4 of
the solution's largest entry; one block; two blocks. It is also held
against the JAX package's own cyclic reduction,
``banded_flat.block_tridiag_solve_cr``, at 1e-9 in f64, odd G included. The
CUDA kernel is held against the plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.ops.pallas_tridiag import tridiag_solve as pallas_solve
from slam_tricks_tpu.solvers.banded_flat import block_tridiag_solve_cr
from slam_tricks_tpu_torch.ops import tridiag_solve as tri
import tests.torch_util  # noqa: F401  (caps torch's threads)


def _system(G, m, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    Gm = rng.normal(size=(G, m, m + 4))
    D = (Gm @ Gm.transpose(0, 2, 1) + (m / 2) * np.eye(m)[None]).astype(dtype)
    E = (0.3 * rng.normal(size=(G - 1, m, m))).astype(dtype)
    r = rng.normal(size=(G, m)).astype(dtype)
    return D, E, r


def _dense(D, E, r):
    G, m, _ = D.shape
    M = np.zeros((G, m, G, m))
    for g in range(G):
        M[g, :, g, :] = D[g]
    for g in range(G - 1):
        M[g + 1, :, g, :] = E[g]
        M[g, :, g + 1, :] = E[g].T
    return np.linalg.solve(M.reshape(G * m, G * m),
                           np.asarray(r, np.float64).reshape(-1)).reshape(G, m)


@pytest.mark.parametrize("G, m, seed, dtype, tol", [
    (12, 16, 0, np.float64, 1e-9),
    (16, 48, 3, np.float32, 1e-4),
    (1, 8, 5, np.float64, 1e-9),
    (2, 8, 2, np.float64, 1e-9),
])
def test_plain_matches_pallas_and_dense(G, m, seed, dtype, tol):
    D, E, r = _system(G, m, seed=seed, dtype=dtype)
    ref = _dense(D, E, r)
    scale = np.abs(ref).max() if dtype == np.float32 else 1.0
    x = tri.tridiag_solve(*(torch.as_tensor(a) for a in (D, E, r)))
    assert x.dtype == torch.as_tensor(D).dtype and x.shape == (G, m)
    x_pal = pallas_solve(jnp.asarray(D), jnp.asarray(E), jnp.asarray(r),
                         interpret=True)
    for got in (x.numpy(), np.asarray(x_pal)):
        assert np.abs(got.astype(np.float64) - ref).max() < tol * scale
    assert np.abs(x.numpy().astype(np.float64)
                  - np.asarray(x_pal, np.float64)).max() < tol * scale


# G = 7 and 13 have levels of odd size; 1 and 2 reduce at once or not at all
@pytest.mark.parametrize("G, m, seed", [(7, 8, 1), (13, 8, 4), (1, 8, 6),
                                        (2, 8, 7), (33, 6, 8)])
def test_plain_matches_jax_cyclic_reduction(G, m, seed):
    D, E, r = _system(G, m, seed=seed)
    x = tri.tridiag_solve(*(torch.as_tensor(a) for a in (D, E, r)))
    ref = np.asarray(block_tridiag_solve_cr(jnp.asarray(D), jnp.asarray(E),
                                            jnp.asarray(r)))
    assert np.abs(x.numpy() - ref).max() < 1e-9
    assert np.abs(x.numpy() - _dense(D, E, r)).max() < 1e-9


def test_plain_non_spd_gives_nan():
    """A block that is not positive definite gives NaN, as in the kernel,
    which the solver's bad-step branch turns into a zero step."""
    D, E, r = _system(5, 8, seed=9)
    D[2] = -D[2]
    x = tri.tridiag_solve(*(torch.as_tensor(a) for a in (D, E, r)))
    assert np.isnan(x.numpy()).any()


def test_size_limit():
    """A block's working tile (the m x m block padded to whole 32-row
    panels, 2 m + 1 columns carried along) sits in shared memory up to
    m = 128 in f32 and m = 96 in f64, in a global scratch beyond; the kernel
    takes every m = 6 K of the banded layout's bands K <= 32."""
    from slam_tricks_tpu_torch.ops._build import SMEM_PER_BLOCK

    for dtype, m_max in ((torch.float32, 128), (torch.float64, 96)):
        assert tri.smem_bytes(m_max, dtype) <= SMEM_PER_BLOCK
        assert tri.smem_bytes(m_max + 1, dtype) > SMEM_PER_BLOCK
    assert tri.tile_values(48) == 64 * (64 + 97 + 1)
    assert tri.MAX_M >= 6 * 32
