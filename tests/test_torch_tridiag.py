"""SPD block-tridiagonal solve (slam_tricks_tpu_torch/ops/tridiag_solve.py).

The plain torch version, which the wrapper runs on a CPU tensor, is held
against the Pallas kernel it replaces, ``pallas_tridiag.tridiag_solve`` in
interpret mode, and against a dense f64 solve, with the cases and bounds of
tests/test_pallas_tridiag.py: (12, 16) f64 to 1e-9; (16, 48) f32 to 1e-4 of
the solution's largest entry; one block; two blocks. The CUDA kernel is
held against the plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tricks_tpu.ops.pallas_tridiag import tridiag_solve as pallas_solve
from slam_tricks_tpu_torch.ops import tridiag_solve as tri


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


def test_size_limit():
    """The kernel keeps its three m x m tiles in shared memory up to m = 138
    in f32 and m = 97 in f64, in a global scratch beyond; it takes every
    m = 6 K of the banded layout's bands K <= 32."""
    from slam_tricks_tpu_torch.ops._build import SMEM_PER_BLOCK

    for dtype, m_max in ((torch.float32, 138), (torch.float64, 97)):
        assert tri.smem_bytes(m_max, dtype) <= SMEM_PER_BLOCK
        assert tri.smem_bytes(m_max + 1, dtype) > SMEM_PER_BLOCK
    assert tri.MAX_M >= 6 * 32
