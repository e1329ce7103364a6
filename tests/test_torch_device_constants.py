"""The index tensors and constants that the solvers make once a device
(``common.device_index`` / ``device_constant``, the super-block tables of
``banded_flat._group_superblocks``) in place of Python lists copied to the
device at every use, and the kernels' ``out=`` tensors that the graphed LM
loop writes into, on the CPU: each gives the bits of the list-indexed or
freshly allocated computation it replaced; a solve on the CPU runs the
eager loop and leaves the CUDA graphs' counters alone."""

import numpy as np
import pytest
import torch

import tests.torch_util  # noqa: F401  (caps torch's threads)
from slam_tricks_tpu_torch.ops import ba_assemble, spd_solve, tridiag_solve
from slam_tricks_tpu_torch.sim import make_scene, perturb_scene
from slam_tricks_tpu_torch.solvers import banded_flat, schur, schur_flat_sm
from slam_tricks_tpu_torch.solvers.common import (device_constant,
                                                  device_index)


def _dense_superblocks(bands, C):
    """Dm, Em of the band blocks by their definition: the block matrix over
    G Kb cameras with S[c + o, c] = bands[o, c] and S[c, c + o] its
    transpose for every camera c < C (rows past G Kb dropped), identity
    diagonal blocks at the padding cameras, cut into Kb x Kb super-blocks
    one camera block at a time."""
    K = bands.shape[0]
    Kb = max(K, 2)
    G = -(-C // Kb)
    blk = {}
    for c in range(C):
        for o in range(K):
            if c + o < G * Kb:
                blk[(c + o, c)] = bands[o, c]
                if o > 0:
                    blk[(c, c + o)] = bands[o, c].T
    for c in range(C, G * Kb):
        blk[(c, c)] = torch.eye(6, dtype=bands.dtype)
    zero = torch.zeros((6, 6), dtype=bands.dtype)

    def super_block(gr, gc):
        return torch.cat([torch.cat([blk.get((gr * Kb + a, gc * Kb + b), zero)
                                     for b in range(Kb)], dim=1)
                          for a in range(Kb)], dim=0)
    Dm = torch.stack([super_block(g, g) for g in range(G)])
    Em = (torch.stack([super_block(g + 1, g) for g in range(G - 1)])
          if G > 1 else bands.new_zeros((0, 6 * Kb, 6 * Kb)))
    return Dm, Em


# every band K <= 8; C = 3 Kb + 1 (padding cameras), and C = Kb (G = 1)
@pytest.mark.parametrize("K, C", [(K, c(max(K, 2))) for K in range(1, 9)
                                  for c in (lambda kb: 3 * kb + 1,
                                            lambda kb: kb)])
def test_superblocks_match_the_dense_block_matrix(K, C):
    g = torch.Generator().manual_seed(100 * K + C)
    bands = torch.randn((K, C, 6, 6), generator=g, dtype=torch.float64)
    Dm, Em, Kb = banded_flat._group_superblocks(bands, C)
    ref_D, ref_E = _dense_superblocks(bands, C)
    assert Kb == max(K, 2)
    assert Dm.is_contiguous() and Em.is_contiguous()
    assert torch.equal(Dm, ref_D) and torch.equal(Em, ref_E)
    # the tables are made once a (K, C) and device
    assert banded_flat._superblock_index(K, C, bands.device)[0] is (
        banded_flat._superblock_index(K, C, bands.device)[0])


def _hll(L, dtype, seed):
    """(6, L) landmark blocks, SPD, every fifth one empty (all zero)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((L, 3, 4), generator=g, dtype=dtype)
    H = A @ A.mT
    iu = torch.triu_indices(3, 3)
    Hll = H[:, iu[0], iu[1]].T.contiguous()
    Hll[:, ::5] = 0.0
    return Hll


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_damp_hll_keeps_the_list_index_bits(dtype):
    Hll = _hll(203, dtype, 3)
    lam = torch.tensor(3e-3, dtype=dtype)
    diag = schur_flat_sm._DIAG3
    dll = torch.clamp_min(Hll[diag], 1e-12)
    damp = torch.zeros_like(Hll)
    damp[diag] = lam * dll
    eye3 = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], dtype=dtype)[:, None]
    ref = torch.where((Hll[0] + Hll[3] + Hll[5]) <= 0.0, eye3, Hll + damp)
    got, got_dll = schur_flat_sm.damp_hll(Hll, lam)
    assert torch.equal(got, ref) and torch.equal(got_dll, dll)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_sites_keep_the_list_index_bits(dtype):
    g = torch.Generator().manual_seed(5)
    flat = torch.randn((7, 21), generator=g, dtype=dtype)
    assert torch.equal(schur_flat_sm._sym6_expand(flat),
                       flat[..., schur_flat_sm._SYM6].reshape(7, 6, 6))
    h = torch.randn((6, 40), generator=g, dtype=dtype)
    v = torch.randn((3, 40), generator=g, dtype=dtype)
    H = h[banded_flat._SYM33].view(3, 3, -1)
    assert torch.equal(banded_flat._mat3vec(h, v),
                       H[:, 0] * v[0] + H[:, 1] * v[1] + H[:, 2] * v[2])


def test_device_constants_are_made_once():
    a = device_index([0, 6, 11], "cpu")
    assert a is device_index((0, 6, 11), torch.device("cpu"))
    assert a.dtype == torch.int64 and a.tolist() == [0, 6, 11]
    b = device_constant((0.0, 1.0), torch.float32, "cpu")
    assert b is device_constant([0.0, 1.0], torch.float32, "cpu")
    assert b.dtype == torch.float32 and b.tolist() == [0.0, 1.0]
    assert device_constant((0.0, 1.0), torch.float64, "cpu") is not b


def test_kernel_wrappers_write_into_out():
    sc = make_scene(n_per_wall=12, n_cams=8, seed=5, dtype=torch.float64,
                    device="cpu")
    poses0, points0, _ = perturb_scene(sc, seed=6)
    work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                         dtype=torch.float64)
    args = (poses0.R.reshape(sc.n_cams, 9), poses0.t, points0, work.uv0,
            work.uv1, work.w, work.cam_of_slot)
    out = ba_assemble.assemble_out(sc.n_cams, work.w, work.cam_index)
    got = ba_assemble.linearize_assemble(*args, out=out)
    ref = ba_assemble.linearize_assemble(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got[-1] is out.cost
    assert all(x.data_ptr() >= out.buf.data_ptr() for x in got[:-1])

    g = torch.Generator().manual_seed(7)
    A = torch.randn((30, 30), generator=g, dtype=torch.float64)
    S, b = A @ A.T + 30 * torch.eye(30, dtype=torch.float64), A[0]
    x = torch.empty_like(b)
    assert spd_solve.spd_solve(S, b, out=x) is x
    assert torch.equal(x, spd_solve.spd_solve(S, b))
    with pytest.raises(ValueError):
        spd_solve.spd_solve(S, b, out=torch.empty(29, dtype=torch.float64))

    D = torch.stack([S[:12, :12]] * 3)
    E = torch.stack([0.1 * S[:12, 12:24]] * 2)
    r = A[:3, :12].contiguous()
    x = torch.empty_like(r)
    assert tridiag_solve.tridiag_solve(D, E, r, out=x) is x
    assert torch.equal(x, tridiag_solve.tridiag_solve(D, E, r))


def test_a_solve_on_the_cpu_runs_the_eager_loop():
    sc = make_scene(n_per_wall=12, n_cams=8, seed=5, dtype=torch.float64,
                    device="cpu")
    poses0, points0, fixed = perturb_scene(sc, seed=6)
    work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                         dtype=torch.float64)
    before = (schur.EAGER_ITERATIONS, schur.GRAPH_CAPTURES,
              schur.GRAPH_REPLAYS)
    out = schur_flat_sm.solve_ba_flat_sm(poses0, points0, work,
                                         fixed_mask=fixed, max_iters=3)
    assert out.it >= 1
    assert (schur.EAGER_ITERATIONS - before[0], schur.GRAPH_CAPTURES,
            schur.GRAPH_REPLAYS) == (out.it, before[1], before[2])
    assert schur._GRAPHS == [None]
    assert np.isfinite(float(out.cost))


def test_release_graphs_empties_the_cache():
    held = schur._GRAPHS[0]
    schur._GRAPHS[0] = object()
    schur.release_graphs()
    assert schur._GRAPHS == [None]
    schur._GRAPHS[0] = held
