"""The port's CUDA kernels against their plain torch versions on the card,
and the headline solve through them against the CPU path (which the other
test_torch_* files hold against the JAX package). This file imports no jax,
so it also runs on a GPU machine that has none:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Every test skips without a CUDA device. Tolerances, as max |a - b| / max |b|:
ba_assemble 1e-4 in f32 and 1e-10 in f64 (its sums run in a fixed order,
another than the plain version's index_add_; two launches agree bitwise);
spd_solve 5e-6 in f32 and 1e-9 in f64 on well-conditioned SPD systems
(two Cholesky solves, tiles against cuSOLVER's blocking);
tridiag_solve 1e-4 in f32 and 1e-9 in f64 on well-conditioned systems (the
same cyclic reduction, sums in another order), with one right-hand side and
with q up to 16 (a 3-D r with q = 1 gives the 2-D answer's bits, q = 17 is
refused); ba_assemble with each robust
loss as without one;
undistort 2.5e-4 px in f32 (a few ulp at 700 px: the kernel's steps are
fused multiply-adds with an approximate reciprocal of the determinant) and
1e-9 px in f64; the f64 solves (paths A, B, the loop-closure solve, the
incremental stream, schur.solve_ba dense and paired, schur_flat dense and
PCG, a sliding-window shift, the pose graphs' dense, chain,
relative-state and Sim(3) solves, and the VI smoothers, chain with its
covariances and dense, the two-view refinement and Zhang calibration) to
1e-8 in the poses, as against JAX; two f32 solves of paths A and B give
the same bits; ba_assemble at the large-C grid (1024 cameras, K = 464)
and at the two-view grid (K = 2, L = 2000) as above, and spd_solve at
n = 6144 and at the geometric slice's n = 12 and 63; the front end's
paths (FO, SD, LK, DA, ORB, CB, PAN: no kernel) in f64 against the CPU at
the CPU tests' sizes; the host utilities on the card (Timer.lap waits for
queued products: within 10% + 5 ms of CUDA events around them; a
checkpoint of CUDA tensors loads onto the card and onto the CPU, the same
bits) and an example run on the card by default, its numbers within 5e-3
relative of its --cpu run; the distributed banded and sharded solvers on
two gloo ranks that share the card, the same bits on both ranks and
within 1e-8 of the same solve on the CPU; the graphed LM loop of paths A
and B (``schur.lm_graphed``) against the eager ``schur.lm_loop`` from the
same start, in f32 and f64: the same bits in the final state, cost,
iterations and costs, returned tensors a later solve leaves alone, four
graphs captured on a layout's first solve and none after (anew for
another fixed mask or layout, none for a solve of one iteration, anew
after ``schur.release_graphs()``), one memory pool for every layout's
graphs, and one sync an iteration; BAL's 9-wide ba_assemble over a
problem's track-length buckets against its plain version (1e-4 in f32,
1e-10 in f64, two launches the same bits) and the graphed BAL solve
(``schur_bal.solve_bal``) against its eager loop, the same bits."""

import numpy as np
import pytest
import torch

from slam_tricks_tpu_torch.ops import (ba_assemble, spd_solve, tridiag_solve,
                                       undistort)
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.sim import (make_loop_scene, make_scene,
                                       make_trajectory_scene, perturb_scene)
from slam_tricks_tpu_torch.solvers import (banded_flat, incremental,
                                           loop_flat, pcg_flat, schur,
                                           schur_flat, schur_flat_sm,
                                           sliding_window)

pytestmark = pytest.mark.cuda


# the helpers of tests/torch_util.py, repeated: this file must import with
# --noconftest on a machine where another `tests` package may shadow ours
def require_cuda():
    """Skip the calling test unless a CUDA device is present (decided in the
    test, never at import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def rel_err(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _problem(dtype, device):
    sc = make_scene(n_per_wall=60, n_cams=16, seed=3, dtype=dtype,
                    device=device)
    poses0, points0, fixed = perturb_scene(sc, seed=4)
    work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                         dtype=dtype)
    return poses0, points0, fixed, work


_ASSEMBLE_OUT = ("Hpp", "gp", "Hll", "gl", "W", "cost")


def _assemble_args(layout, dtype, device):
    """(kernel arguments, camera index) of the headline layout ("A", 16
    cameras) or of a 64-camera trajectory layout ("B", track_len 8, chunks
    of 32 landmarks that share their first camera)."""
    if layout == "A":
        poses0, points0, _, work = _problem(dtype, device)
    else:
        sc = make_trajectory_scene(n_cams=64, n_points=3000, track_len=8,
                                   seed=5, dtype=dtype, device=device)
        poses0, points0, _ = perturb_scene(sc, pose_rot_noise=0.002,
                                           pose_trans_noise=0.01,
                                           point_noise=0.01, seed=6)
        work = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                             dtype=dtype)
        points0 = points0[work.gather_idx]
    args = (poses0.R.reshape(work.n_cams, 9), poses0.t, points0, work.uv0,
            work.uv1, work.w, work.cam_of_slot)
    return args, work.cam_index


@pytest.mark.parametrize("layout", ["A", "B"])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-10)])
def test_ba_assemble_kernel_matches_plain(dtype, tol, layout):
    dev = require_cuda()
    args, index = _assemble_args(layout, dtype, dev)
    ref = ba_assemble.linearize_assemble_plain(*args)
    for cam_index in (index, None):     # the layout's index, the wrapper's
        before = ba_assemble.LAUNCHES
        out = ba_assemble.linearize_assemble(*args, cam_index)
        torch.cuda.synchronize()
        assert ba_assemble.LAUNCHES == before + 1
        for name, a, b in zip(_ASSEMBLE_OUT, out, ref):
            assert a.shape == b.shape and a.device == b.device, name
            assert rel_err(a, b) < tol, (name, rel_err(a, b))


@pytest.mark.parametrize("layout", ["A", "B"])
def test_ba_assemble_kernel_is_deterministic(layout):
    """No float atomics: two launches on the same inputs, f32, give the
    same bits in every output."""
    dev = require_cuda()
    args, index = _assemble_args(layout, torch.float32, dev)
    one = ba_assemble.linearize_assemble(*args, index)
    two = ba_assemble.linearize_assemble(*args, index)
    for name, a, b in zip(_ASSEMBLE_OUT, one, two):
        assert torch.equal(a, b), name


_LOSSES = [robust.huber(1.0), robust.cauchy(1.0), robust.tukey(4.685),
           robust.huber(0.01), robust.chi2_gate(0.0)]


def _gate_threshold(args):
    """A chi-square gate threshold in the lowest gap wider than 1e-3
    relative between two live slots' squared residuals s in the upper 5%:
    the gate is a step, and in f32 the kernel's fused multiply-adds move s
    by ~1e-5 relative, so a slot on the threshold would add itself in one
    version and not in the other."""
    (r0, r1), *_ = ba_assemble._linearize_sm(*args)
    live = args[5] > 0
    s = torch.sort(((r0 * r0 + r1 * r1)[live] / args[5][live]).double()).values
    top = s[int(0.95 * s.numel()):]
    wide = torch.nonzero(top[1:] / top[:-1] > 1.001)
    assert wide.numel()
    i = int(wide[0])
    return float(torch.sqrt(top[i] * top[i + 1]))


@pytest.mark.parametrize("loss", _LOSSES, ids=lambda x: x.kind + str(x.param))
@pytest.mark.parametrize("layout", ["A", "B"])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-10)])
def test_ba_assemble_kernel_with_loss_matches_plain(dtype, tol, layout, loss):
    """The gate (its threshold set from the slots, ``_gate_threshold``)
    turns the live slots above it off (weight 0). It also takes off the
    slots with the largest residuals, which set max |gl| and max |gp|: what
    is left are small sums that cancel, and f32 rounding alone (the plain
    version in f32 against f64) reaches 1.7e-4 of max |gl| at layout B, so
    the gate's f32 tolerance is 5e-4."""
    dev = require_cuda()
    args, index = _assemble_args(layout, dtype, dev)
    if loss.kind == "chi2_gate":
        loss = robust.chi2_gate(_gate_threshold(args))
        tol = 5e-4 if dtype == torch.float32 else tol
    ref = ba_assemble.linearize_assemble_plain(*args, loss)
    before = ba_assemble.LAUNCHES
    out = ba_assemble.linearize_assemble(*args, index, loss)
    again = ba_assemble.linearize_assemble(*args, index, loss)
    torch.cuda.synchronize()
    assert ba_assemble.LAUNCHES == before + 2
    for name, a, b, a2 in zip(_ASSEMBLE_OUT, out, ref, again):
        assert rel_err(a, b) < tol, (name, rel_err(a, b))
        assert torch.equal(a, a2), name


def test_ba_assemble_kernel_many_cameras():
    """C = 6000 cameras, more than the rows (R, t) a block's shared memory
    held when the kernel staged them (~4,800 in f32): a random slot grid,
    K = 8, L = 4000, 80% of the slots live, points in front of cameras
    near the identity."""
    dev = require_cuda()
    C, K, L = 6000, 8, 4000
    rng = np.random.default_rng(6000)
    ang = rng.normal(scale=0.05, size=(C, 3))
    Kx = np.zeros((C, 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2], Kx[:, 1, 2] = -ang[:, 2], ang[:, 1], -ang[:, 0]
    Kx = Kx - Kx.transpose(0, 2, 1)
    R = np.eye(3)[None] + Kx + 0.5 * Kx @ Kx        # near-rotations
    t = rng.normal(scale=0.1, size=(C, 3))
    points = np.c_[rng.uniform(-1, 1, (L, 2)), rng.uniform(4, 6, L)]
    live = rng.random((K, L)) < 0.8
    w = np.where(live, rng.uniform(0.5, 2.0, (K, L)), 0.0)
    cam = np.where(live, rng.integers(0, C, (K, L)), 0).astype(np.int32)
    uv = rng.normal(scale=0.2, size=(2, K, L))

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    args = (f32(R.reshape(C, 9)), f32(t), f32(points), f32(uv[0]), f32(uv[1]),
            f32(w), torch.as_tensor(cam, device=dev))
    ref = ba_assemble.linearize_assemble_plain(*args)
    out = ba_assemble.linearize_assemble(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(_ASSEMBLE_OUT, out, ref):
        assert rel_err(a, b) < 1e-4, (name, rel_err(a, b))


def _spd_system(n, dtype, device):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(n, n))
    S = torch.as_tensor(A @ A.T + n * np.eye(n), dtype=dtype, device=device)
    b = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=device)
    return S, b


# 577 = 18 * 32 + 1 leaves a ragged last tile of one row; 1 and 31 are one
# ragged tile; 300 in f64 is ragged too; 6144 is the reduced camera system
# of 1024 cameras (schur.solve_ba's paired comparator, schur_flat_sm at
# large C); the large-n kernel (blocked 1) at BAL Dubrovnik's 3204 = 50 *
# 64 + 4 (a ragged 4-row last panel), at the crossover, and at 2049 = 32 *
# 64 + 1 in f64; the small kernel one below the crossover
@pytest.mark.parametrize("n, dtype, tol, blocked", [
    (36, torch.float32, 5e-6, 0), (200, torch.float32, 5e-6, 0),
    (576, torch.float32, 5e-6, 0), (577, torch.float32, 5e-6, 0),
    (1, torch.float32, 5e-6, 0), (31, torch.float32, 5e-6, 0),
    (300, torch.float64, 1e-9, 0), (577, torch.float64, 1e-9, 0),
    (6144, torch.float32, 5e-6, 1), (3204, torch.float32, 5e-6, 1),
    (spd_solve.BLOCKED_MIN_N, torch.float32, 5e-6, 1),
    (spd_solve.BLOCKED_MIN_N - 1, torch.float32, 5e-6, 0),
    (2049, torch.float64, 1e-9, 1)])
def test_spd_solve_kernel_matches_plain(n, dtype, tol, blocked):
    dev = require_cuda()
    S, b = _spd_system(n, dtype, dev)
    ref = spd_solve.spd_solve_plain(S, b)
    before = (spd_solve.LAUNCHES, spd_solve.BLOCKED_CALLS)
    x = spd_solve.spd_solve(S, b)
    torch.cuda.synchronize()
    assert spd_solve.LAUNCHES == before[0] + 1
    assert spd_solve.BLOCKED_CALLS == before[1] + blocked
    assert x.dtype == dtype
    assert rel_err(x, ref) < tol


def test_spd_solve_kernel_at_size_limit():
    """n = MAX_N, the largest the kernel takes (n * n < 2**31), solved on
    the card by the large-n kernel (its padded copy 46,400²): S diagonally
    dominant (off-diagonal entries in [-1, 1], diagonal n), so SPD with a
    condition number below 3; held by the residual |Sx - b| / |b| < 1e-4
    in f32."""
    dev = require_cuda()
    n = spd_solve.MAX_N
    gen = torch.Generator(device=dev).manual_seed(0)
    S = torch.rand((n, n), generator=gen, device=dev).mul_(2).sub_(1)
    S.diagonal().fill_(float(n))
    b = torch.rand(n, generator=gen, device=dev)
    before = spd_solve.BLOCKED_CALLS
    x = spd_solve.spd_solve(S, b)   # reads the upper triangle only
    assert spd_solve.BLOCKED_CALLS == before + 1
    U = torch.triu(S)
    res = U @ x + torch.triu(S, 1).T @ x - b
    del U
    assert float(res.norm() / b.norm()) < 1e-4


def test_spd_solve_kernel_refuses_too_large_n():
    dev = require_cuda()
    n = spd_solve.MAX_N + 1
    S = torch.zeros(1, device=dev).expand(n, n)   # the size check comes first
    with pytest.raises(ValueError, match="outside"):
        spd_solve.spd_solve(S, torch.zeros(n, device=dev))


@pytest.mark.parametrize("n, bad", [(3, 1), (200, 7), (200, 199), (577, 576),
                                    (577, 300), (3204, 7), (3204, 1600),
                                    (3204, 3202)])
def test_spd_solve_kernel_non_spd_gives_nan(n, bad):
    """A pivot <= 0 (row `bad` of an SPD matrix made negative: in the first
    tile, the last, the ragged last tile of 577 or a middle one; at 3204,
    on the large-n kernel, in the first 64-row panel, a middle one and the
    ragged 4-row last one) gives NaN in every value, as the plain version
    does, in f32 and f64; the cooperative grid still reaches every barrier
    (the call returns)."""
    dev = require_cuda()
    for dtype in (torch.float32, torch.float64):
        S, b = _spd_system(n, dtype, dev)
        S[bad, bad] = -S[bad, bad]
        x = spd_solve.spd_solve(S, b)
        torch.cuda.synchronize()
        assert torch.isnan(x).all()
        assert torch.isnan(spd_solve.spd_solve_plain(S, b)).all()


def test_solve_on_cuda_matches_cpu():
    dev = require_cuda()
    poses0, points0, fixed, work = _problem(torch.float64, "cpu")
    ref = schur_flat_sm.solve_ba_flat_sm(poses0, points0, work,
                                         fixed_mask=fixed, max_iters=15)
    poses0, points0, fixed, work = _problem(torch.float64, dev)
    assert work.w.device.type == "cuda"
    out = schur_flat_sm.solve_ba_flat_sm(poses0, points0, work,
                                         fixed_mask=fixed, max_iters=15)
    assert (out.it, out.done) == (ref.it, ref.done)
    np.testing.assert_allclose(out.poses.t.cpu().numpy(), ref.poses.t.numpy(),
                               rtol=0, atol=1e-8)


def _tridiag_system(G, m, seed, dtype, device):
    rng = np.random.default_rng(seed)
    Gm = rng.normal(size=(G, m, m + 4))
    D = Gm @ Gm.transpose(0, 2, 1) + (m / 2) * np.eye(m)[None]
    E = 0.3 * rng.normal(size=(G - 1, m, m))
    r = rng.normal(size=(G, m))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (D, E, r))


# m = 128 (f32) and 96 (f64) are the largest with a block's tile in shared
# memory; 129, 97 and 192 (the widest band, K = 32) take the global scratch;
# m = 8, 16, 48, 97, 99, 129, 138 and 139 pad the tile to whole panels;
# G = 127, 5 and 13 have levels of odd size
@pytest.mark.parametrize("G, m, dtype, tol", [
    (128, 48, torch.float32, 1e-4), (12, 16, torch.float64, 1e-9),
    (1, 48, torch.float32, 1e-4), (3, 138, torch.float32, 1e-4),
    (2, 97, torch.float64, 1e-9), (3, 139, torch.float32, 1e-4),
    (2, 98, torch.float64, 1e-9), (4, 192, torch.float32, 1e-4),
    (4, 192, torch.float64, 1e-9), (127, 48, torch.float32, 1e-4),
    (5, 48, torch.float32, 1e-4), (13, 8, torch.float64, 1e-9),
    (3, 99, torch.float64, 1e-9), (16, 192, torch.float32, 1e-4),
    (2, 128, torch.float32, 1e-4), (2, 129, torch.float32, 1e-4),
    (2, 96, torch.float64, 1e-9)])
def test_tridiag_kernel_matches_plain(G, m, dtype, tol):
    dev = require_cuda()
    D, E, r = _tridiag_system(G, m, G + m, dtype, dev)
    ref = tridiag_solve.tridiag_solve_plain(D, E, r)
    before = tridiag_solve.LAUNCHES
    x = tridiag_solve.tridiag_solve(D, E, r)
    torch.cuda.synchronize()
    assert tridiag_solve.LAUNCHES == before + 1
    assert x.shape == (G, m) and x.dtype == dtype
    assert rel_err(x, ref) < tol


def test_tridiag_kernel_non_spd_gives_nan():
    """A block that is not positive definite gives NaN, as in the plain
    version (and JAX's cyclic reduction), which the LM loop rejects."""
    dev = require_cuda()
    D, E, r = _tridiag_system(5, 48, 1, torch.float32, dev)
    D[2] = -D[2]
    x = tridiag_solve.tridiag_solve(D, E, r)
    torch.cuda.synchronize()
    assert torch.isnan(x).any()
    assert torch.isnan(tridiag_solve.tridiag_solve_plain(D, E, r)).any()


def _tridiag_rhs(G, m, q, seed, dtype, device):
    D, E, _ = _tridiag_system(G, m, seed, dtype, device)
    r = np.random.default_rng(seed + 1).normal(size=(G, m, q))
    return D, E, torch.as_tensor(r, dtype=dtype, device=device)


# many right-hand sides r (G, m, q): the VI chain's (1024, 9, 7) and
# (1024, 9, 6), odd G (1023, 13, 5), one block, q up to MAX_Q = 16; m = 96
# f64 with q = 16 and m = 192 take the global scratch
@pytest.mark.parametrize("G, m, q, dtype, tol", [
    (1024, 9, 7, torch.float32, 1e-4), (1024, 9, 6, torch.float64, 1e-9),
    (1023, 9, 7, torch.float32, 1e-4), (1023, 9, 7, torch.float64, 1e-9),
    (13, 9, 16, torch.float32, 1e-4), (13, 9, 16, torch.float64, 1e-9),
    (5, 48, 6, torch.float32, 1e-4), (1, 9, 7, torch.float64, 1e-9),
    (127, 48, 1, torch.float32, 1e-4), (3, 96, 16, torch.float64, 1e-9),
    (2, 192, 7, torch.float32, 1e-4)])
def test_tridiag_kernel_many_rhs_matches_plain(G, m, q, dtype, tol):
    dev = require_cuda()
    D, E, r = _tridiag_rhs(G, m, q, G + m + q, dtype, dev)
    ref = tridiag_solve.tridiag_solve_plain(D, E, r)
    before = tridiag_solve.LAUNCHES
    x = tridiag_solve.tridiag_solve(D, E, r)
    torch.cuda.synchronize()
    assert tridiag_solve.LAUNCHES == before + 1
    assert x.shape == (G, m, q) and x.dtype == dtype
    assert rel_err(x, ref) < tol


def test_tridiag_kernel_one_rhs_as_3d_is_bitwise_2d():
    """r (G, m, 1) runs the single right-hand side's instance: the same
    bits as r (G, m), path B's shape."""
    dev = require_cuda()
    D, E, r = _tridiag_system(128, 48, 7, torch.float32, dev)
    x2 = tridiag_solve.tridiag_solve(D, E, r)
    x3 = tridiag_solve.tridiag_solve(D, E, r[..., None].contiguous())
    torch.cuda.synchronize()
    assert x3.shape == (128, 48, 1)
    assert torch.equal(x3[..., 0], x2)


def test_tridiag_kernel_refuses_too_many_rhs():
    dev = require_cuda()
    D, E, r = _tridiag_rhs(4, 9, tridiag_solve.MAX_Q + 1, 0, torch.float32,
                           dev)
    with pytest.raises(ValueError):
        tridiag_solve.tridiag_solve(D, E, r)


def test_tridiag_kernel_refuses_too_large_blocks():
    dev = require_cuda()
    m = tridiag_solve.MAX_M + 1
    D, E, r = _tridiag_system(2, m, 0, torch.float32, dev)
    with pytest.raises(ValueError):
        tridiag_solve.tridiag_solve(D, E, r)


_UNDISTORT_PARAMS = (458.654, 457.296, 367.215, 248.375, -0.28340811,
                     0.07395907, 0.0, 0.00019359, 1.76187114e-05)


# offset 1 starts the pixels 8 mod 16 bytes into a buffer (f32: a head pixel
# before the first 16-byte vector, and an output of another phase than the
# input); 3001, 101 and 1 are odd counts (a tail pixel), 101 and 1 below one
# block; n = 0 launches nothing
@pytest.mark.parametrize("n, dtype, tol, offset, iters", [
    (3001, torch.float32, 2.5e-4, 0, 5), (500, torch.float64, 1e-9, 0, 5),
    (3001, torch.float32, 2.5e-4, 1, 5), (101, torch.float32, 2.5e-4, 1, 5),
    (1, torch.float32, 2.5e-4, 1, 5), (101, torch.float32, 2.5e-4, 0, 5),
    (0, torch.float32, 2.5e-4, 0, 5), (3001, torch.float32, 2.5e-4, 0, 0),
    (3001, torch.float32, 2.5e-4, 0, 1), (3001, torch.float32, 2.5e-4, 0, 8),
    (501, torch.float64, 1e-9, 1, 8), (501, torch.float64, 1e-9, 0, 1)])
def test_undistort_kernel_matches_plain(n, dtype, tol, offset, iters):
    dev = require_cuda()
    rng = np.random.default_rng(n)
    buf = torch.as_tensor(rng.uniform([50, 50], [700, 430], size=(n + 1, 2)),
                          dtype=dtype, device=dev)
    px = buf[offset:offset + n]
    assert px.data_ptr() % 16 == offset * 2 * px.element_size() % 16
    ref = undistort.undistort_plain(px, _UNDISTORT_PARAMS, iters)
    before = undistort.LAUNCHES
    out = undistort.undistort(px, _UNDISTORT_PARAMS, iters)
    torch.cuda.synchronize()
    assert undistort.LAUNCHES == before + (n > 0)
    assert out.shape == (n, 2) and out.dtype == dtype
    if n:
        assert float((out - ref).abs().max()) < tol


def test_undistort_points_fast_takes_a_strided_view():
    """pts[:, :2] of an (N, 3) tensor is not contiguous: the kernel gets a
    contiguous copy, and the result is the plain version's on the view."""
    from slam_tricks_tpu_torch.residuals import camera

    dev = require_cuda()
    rng = np.random.default_rng(7)
    pts = torch.as_tensor(rng.uniform([50, 50, 0], [700, 430, 1],
                                      size=(2001, 3)),
                          dtype=torch.float32, device=dev)
    view = pts[:, :2]
    assert not view.is_contiguous()
    intr = camera.Intrinsics(*_UNDISTORT_PARAMS[:4])
    dist = camera.DistCoeffs(*_UNDISTORT_PARAMS[4:])
    before = undistort.LAUNCHES
    out = camera.undistort_points_fast(intr, dist, view)
    torch.cuda.synchronize()
    assert undistort.LAUNCHES == before + 1
    ref = undistort.undistort_plain(view, _UNDISTORT_PARAMS)
    assert float((out - ref).abs().max()) < 2.5e-4
    cpu = camera.undistort_points_fast(intr, dist, view.cpu())
    assert float((out.cpu() - cpu).abs().max()) < 2.5e-4


def test_undistort_kernel_count_above_int32():
    """n = 2**31 + 5 f32 pixels (17 GB each way): the count crosses ctypes
    and the kernel in 64 bits, and every pixel, the last included, matches
    the plain version (taken in chunks)."""
    dev = require_cuda()
    torch.cuda.empty_cache()
    n = 2 ** 31 + 5
    gen = torch.Generator(device=dev).manual_seed(0)
    px = torch.empty((n, 2), device=dev)
    px[:, 0].uniform_(50, 700, generator=gen)
    px[:, 1].uniform_(50, 430, generator=gen)
    out = undistort.undistort(px, _UNDISTORT_PARAMS)
    err = 0.0
    chunk = 2 ** 26
    for s in range(0, n, chunk):
        ref = undistort.undistort_plain(px[s:s + chunk], _UNDISTORT_PARAMS)
        err = max(err, float((out[s:s + chunk] - ref).abs().max()))
    del px, out, ref
    torch.cuda.empty_cache()
    assert err < 2.5e-4


def _banded_problem(device, n_cams=32, track_len=6, seed=71):
    sc = make_trajectory_scene(n_cams=n_cams, n_points=600,
                               track_len=track_len, seed=seed, pix_noise=1e-3,
                               dtype=torch.float64, device=device)
    poses0, points0, fixed = perturb_scene(sc, pose_rot_noise=0.002,
                                           pose_trans_noise=0.01,
                                           point_noise=0.01, seed=seed + 1)
    bw = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                       dtype=torch.float64)
    return poses0, points0, fixed, bw


# the scene of test_banded_flat.py, and the widest band the layout takes:
# 512 cameras, tracks of 32 (K = 32, super-blocks of m = 192)
@pytest.mark.parametrize("n_cams, track_len, seed, iters, K", [
    (32, 6, 71, 6, 5), (512, 32, 83, 3, 32)])
def test_banded_solve_on_cuda_matches_cpu(n_cams, track_len, seed, iters, K):
    dev = require_cuda()
    problem = dict(n_cams=n_cams, track_len=track_len, seed=seed)
    poses0, points0, fixed, bw = _banded_problem("cpu", **problem)
    assert bw.w.shape[0] == K
    ref = banded_flat.solve_ba_banded(poses0, points0, bw, fixed_mask=fixed,
                                      max_iters=iters)
    poses0, points0, fixed, bw = _banded_problem(dev, **problem)
    before = (tridiag_solve.LAUNCHES, ba_assemble.LAUNCHES)
    out = banded_flat.solve_ba_banded(poses0, points0, bw, fixed_mask=fixed,
                                      max_iters=iters)
    assert tridiag_solve.LAUNCHES - before[0] == out.it
    assert ba_assemble.LAUNCHES - before[1] == out.it + 1
    assert (out.it, out.done) == (ref.it, ref.done)
    np.testing.assert_allclose(out.poses.t.cpu().numpy(), ref.poses.t.numpy(),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("path", ["A", "B"])
def test_solve_gives_the_same_bits_twice(path):
    """No float atomics on the path: two f32 solves of one problem give the
    same bits in the cost, rotations, translations and points."""
    dev = require_cuda()
    if path == "A":
        poses0, points0, fixed, work = _problem(torch.float32, dev)
        solve = lambda: schur_flat_sm.solve_ba_flat_sm(  # noqa: E731
            poses0, points0, work, fixed_mask=fixed, max_iters=10)
    else:
        sc = make_trajectory_scene(n_cams=64, n_points=3000, track_len=8,
                                   seed=5, dtype=torch.float32, device=dev)
        poses0, points0, fixed = perturb_scene(sc, pose_rot_noise=0.002,
                                               pose_trans_noise=0.01,
                                               point_noise=0.01, seed=6)
        bw = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                           dtype=torch.float32)
        solve = lambda: banded_flat.solve_ba_banded(  # noqa: E731
            poses0, points0, bw, fixed_mask=fixed, max_iters=6)
    one, two = solve(), solve()
    for a, b in ((one.cost, two.cost), (one.poses.R, two.poses.R),
                 (one.poses.t, two.poses.t), (one.points, two.points)):
        assert torch.equal(a, b)


def _loop_problem(device, name):
    kw = {"compressed": dict(n_cams=16, n_points=200, track_len=3, seed=31),
          "direct": dict(n_cams=40, n_points=250, track_len=3, seed=41)}[name]
    sc = make_loop_scene(pix_noise=1e-3, dtype=torch.float64, device=device,
                         **kw)
    poses0, points0, fixed = perturb_scene(sc, pose_rot_noise=0.002,
                                           pose_trans_noise=0.01,
                                           point_noise=0.01,
                                           seed=kw["seed"] + 1)
    lw = loop_flat.build_loop_work(sc.obs, sc.n_cams, sc.n_points,
                                   dtype=torch.float64, max_band=3)
    return poses0, points0, fixed, lw


@pytest.mark.parametrize("name, loss", [("compressed", None),
                                        ("direct", None),
                                        ("compressed", robust.tukey(0.02))])
def test_loop_solve_on_cuda_matches_cpu(name, loss):
    """The loop-closure solve (the single-run part's ba_assemble kernel, a
    launch a step) on the card against the CPU path, f64."""
    dev = require_cuda()
    poses0, points0, fixed, lw = _loop_problem("cpu", name)
    ref = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=6, loss=loss)
    poses0, points0, fixed, lw = _loop_problem(dev, name)
    before = ba_assemble.LAUNCHES
    out = loop_flat.solve_ba_loop(poses0, points0, lw, fixed_mask=fixed,
                                  max_iters=6, loss=loss)
    assert ba_assemble.LAUNCHES - before == out.it + 1
    assert (out.it, out.done) == (ref.it, ref.done)
    np.testing.assert_allclose(out.poses.t.cpu().numpy(), ref.poses.t.numpy(),
                               rtol=0, atol=1e-8)


def test_stream_on_cuda_matches_cpu():
    """The incremental smoother on the card (a camera index an arrival) against
    the CPU path, f64: the trajectory of tests/test_torch_incremental.py."""
    dev = require_cuda()
    states = []
    for device in ("cpu", dev):
        sc = make_trajectory_scene(n_cams=32, n_points=480, track_len=4,
                                   seed=11, pix_noise=1e-3,
                                   dtype=torch.float64, device=device)
        poses0, points0, _ = perturb_scene(sc, pose_rot_noise=0.002,
                                           pose_trans_noise=0.01,
                                           point_noise=0.01, seed=12)
        bw = banded_flat.build_banded_work(sc.obs, 32, 480,
                                           dtype=torch.float64)
        fixed = torch.zeros(32, dtype=torch.bool, device=device)
        fixed[[0, 15]] = True
        before = (ba_assemble.LAUNCHES, tridiag_solve.LAUNCHES)
        state, c_dirty = incremental.smoother_init(poses0, points0, bw,
                                                   n_active=16,
                                                   fixed_mask=fixed)
        for a_prev in (16, 20, 24, 28):
            state, c_dirty = incremental.smoother_arrive(
                state, bw, a_prev=a_prev, a_new=a_prev + 4, c_dirty=c_dirty,
                fixed_mask=fixed, gn_steps=2)
        if device != "cpu":
            tri = tridiag_solve.LAUNCHES - before[1]
            assert 1 <= tri <= 20
            assert ba_assemble.LAUNCHES - before[0] == tri + 2 + 4 * 2 * 5
        states.append(state)
    ref, out = states
    np.testing.assert_allclose(out.poses.t.cpu().numpy(), ref.poses.t.numpy(),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-7)


def test_ba_assemble_kernel_at_large_c_shapes():
    """The slot grid of schur_flat_sm at large C (bench.py's large-C scene:
    1024 cameras, 7200 landmarks, K = 464 slots a landmark, ~2,600 live
    slots a camera), f32: against plain to 1e-4, and two launches bitwise
    equal."""
    dev = require_cuda()
    sc = make_scene(n_per_wall=1200, n_cams=1024, seed=5,
                    dtype=torch.float32, device=dev)
    p0, x0, _ = perturb_scene(sc, 0.002, 0.01, 0.01, seed=6)
    work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points)
    args = (p0.R.reshape(sc.n_cams, 9), p0.t, x0, work.uv0, work.uv1,
            work.w, work.cam_of_slot)
    ref = ba_assemble.linearize_assemble_plain(*args)
    one = ba_assemble.linearize_assemble(*args, work.cam_index)
    two = ba_assemble.linearize_assemble(*args, work.cam_index)
    for name, a, b, c in zip(_ASSEMBLE_OUT, one, ref, two):
        assert rel_err(a, b) < 1e-4, (name, rel_err(a, b))
        assert torch.equal(a, c), name


def _small_scene(device, seed=3):
    sc = make_scene(n_per_wall=10, n_cams=6, seed=seed, pix_noise=1e-3,
                    dtype=torch.float64, device=device)
    return sc, perturb_scene(sc, seed=seed + 6)


@pytest.mark.parametrize("solver", ["dense", "paired"])
def test_solve_ba_on_cuda_matches_cpu(solver):
    """schur.solve_ba through spd_solve on the card against the CPU path,
    f64, to 1e-8 in the poses."""
    dev = require_cuda()
    out = []
    for device in ("cpu", dev):
        sc, (p0, x0, fx) = _small_scene(device)
        kw = {}
        if solver == "paired":
            kw["track_pairs"] = schur.build_track_pairs(
                sc.obs.cam_idx, sc.obs.lm_idx, chunk=257, dtype=torch.float64)
        before = spd_solve.LAUNCHES
        out.append(schur.solve_ba(p0, x0, sc.obs, fixed_mask=fx,
                                  max_iters=10, linear_solver=solver, **kw))
    assert spd_solve.LAUNCHES == before + out[1].it
    ref, got = out
    assert got.it == ref.it
    np.testing.assert_allclose(got.poses.t.cpu().numpy(), ref.poses.t.numpy(),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("linear", ["dense", "pcg"])
def test_solve_ba_flat_on_cuda_matches_cpu(linear):
    """schur_flat.solve_ba_flat through ba_assemble (and spd_solve, dense)
    on the card against the CPU path, f64, 32-camera trajectory, to 1e-8
    in the poses."""
    dev = require_cuda()
    out = []
    for device in ("cpu", dev):
        sc = make_trajectory_scene(n_cams=32, n_points=500, track_len=6,
                                   seed=2, pix_noise=1e-3,
                                   dtype=torch.float64, device=device)
        p0, x0, fx = perturb_scene(sc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=3)
        work = schur_flat.build_flat_work(sc.obs, sc.n_cams, sc.n_points,
                                          dtype=torch.float64)
        kw = {}
        if linear == "pcg":
            kw = dict(pcg_work=pcg_flat.build_pcg_work(
                sc.obs, sc.n_cams, dtype=torch.float64,
                n_points=sc.n_points), cg_iters=400, cg_tol=1e-10)
        before = ba_assemble.LAUNCHES
        out.append(schur_flat.solve_ba_flat(p0, x0, sc.obs, work,
                                            fixed_mask=fx, max_iters=6,
                                            linear=linear, **kw))
    assert ba_assemble.LAUNCHES == before + out[1].it + 1
    ref, got = out
    assert got.it == ref.it
    np.testing.assert_allclose(got.poses.t.cpu().numpy(), ref.poses.t.numpy(),
                               rtol=0, atol=1e-8)


def test_sliding_window_shift_on_cuda_matches_cpu():
    """Two windows and the marginalization between them, through the
    kernels on the card, against the CPU path, f64 (noiseless, so that the
    windows converge), to 1e-8 in the poses and points."""
    dev = require_cuda()
    out = []
    for device in ("cpu", dev):
        sc = make_trajectory_scene(n_cams=18, n_points=400, track_len=5,
                                   seed=97, dtype=torch.float64,
                                   device=device)
        p0, x0, _ = perturb_scene(sc, pose_rot_noise=0.002,
                                  pose_trans_noise=0.01, point_noise=0.01,
                                  seed=98)
        out.append(sliding_window.run_sliding_window(
            sc.obs, p0, x0, window=12, shift=6, na=3, max_iters=8))
    (rp, rx, rd), (gp, gx, gd) = out
    assert len(gd) == len(rd) == 2
    assert [d["it"] for d in gd] == [d["it"] for d in rd]
    np.testing.assert_allclose(gp.t.cpu().numpy(), rp.t.numpy(), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(gx.cpu().numpy(), rx.numpy(), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("path", ["Q", "T", "R", "S"])
def test_pose_graph_solve_on_cuda_matches_cpu(path):
    """The pose-graph solvers on the card against the CPU, f64, 4 LM
    iterations (before the f64 floor, where a stop decision may flip on
    sub-ulp differences) on the spiral pose graph (make_pose_graph, 40
    poses, a loop every 8): Q dense, T chain, R relative state, S the
    same graph lifted to Sim(3) with its scale drifted by e^{-0.004 i}."""
    from slam_tricks_tpu_torch.manifolds import sim3
    from slam_tricks_tpu_torch.sim import make_pose_graph
    from slam_tricks_tpu_torch.solvers import posegraph, posegraph_sim3

    dev = require_cuda()
    outs = []
    for device in ("cpu", dev):
        prob = make_pose_graph(n=40, odo_noise=0.03, meas_noise=0.003,
                               seed=2, device=device)
        args = (prob.i_idx, prob.j_idx, prob.Z)
        if path == "Q":
            out = posegraph.solve_pose_graph(prob.poses_init, *args,
                                             fixed_mask=prob.fixed_mask,
                                             max_iters=4)
        elif path == "S":
            s = torch.exp(-0.004 * torch.arange(
                40, dtype=torch.float64, device=device))
            poses = sim3.from_se3(prob.poses_init, s)
            Z = sim3.from_se3(prob.Z, s[prob.j_idx] / s[prob.i_idx])
            out = posegraph_sim3.solve_pose_graph_sim3(
                poses, prob.i_idx, prob.j_idx, Z, max_iters=4)
        else:
            info = torch.eye(6, dtype=torch.float64, device=device).expand(
                prob.i_idx.shape[0], 6, 6)
            work = posegraph.build_chain_work(*args, info, 40,
                                              dtype=torch.float64,
                                              device=device)
            solve = (posegraph.solve_pose_graph_chain if path == "T"
                     else posegraph.solve_pose_graph_relative)
            out = solve(prob.poses_init, work, max_iters=4)
        outs.append(out)
    cpu, card = outs
    assert card.it == cpu.it == 4
    assert rel_err(card.cost, cpu.cost) < 1e-8
    for a, b in zip(card.poses, cpu.poses):
        assert float((a.cpu() - b).abs().max()) < 1e-8


def _vi_problem(K, device):
    from slam_tricks_tpu_torch.estimation import vi_smoother

    sim = vi_smoother.simulate_vi(n_keyframes=K, samples_per_seg=20,
                                  dt=0.005, sigma_g=2e-4, sigma_a=2e-3,
                                  obs_rot_noise=0.005, obs_trans_noise=0.01,
                                  seed=3, device=device)
    b0 = torch.zeros(6, dtype=torch.float64, device=device)
    pre = vi_smoother.preintegrate_segments(sim, b0[:3], b0[3:],
                                            sigma_g=2e-4, sigma_a=2e-3)
    return sim, pre, b0


@pytest.mark.parametrize("solver", ["chain", "dense"])
def test_vi_smoother_on_cuda_matches_cpu(solver):
    """The chain (tridiag_solve, q = 7) and dense (spd_solve, n = 186) VI
    smoothers at K = 20 in f64, 4 iterations (before the f64 floor), and
    the chain's covariances (tridiag_solve, q = 6): card against CPU to
    1e-8."""
    from slam_tricks_tpu_torch.estimation import vi_chain, vi_smoother

    dev = require_cuda()
    outs, launches = [], []
    for device in ("cpu", dev):
        sim, pre, b0 = _vi_problem(20, device)
        before = (tridiag_solve.LAUNCHES, spd_solve.LAUNCHES)
        if solver == "chain":
            out = vi_chain.solve_vi_chain(pre, sim.obs_poses, sim.obs_poses,
                                          sim.vels_true, b0, max_iters=4,
                                          obs_rot_sigma=0.005,
                                          obs_trans_sigma=0.01)
            cov = vi_chain.vi_chain_covariances(
                pre, sim.obs_poses, out.poses, out.vels, out.bias,
                obs_rot_sigma=0.005, obs_trans_sigma=0.01)
            it = out.it
        else:
            out = vi_smoother.solve_vi_smoother(
                pre, sim.obs_poses, sim.obs_poses, sim.vels_true, b0,
                max_iters=4, obs_rot_sigma=0.005, obs_trans_sigma=0.01)
            cov, it = (), out.iterations
        torch.cuda.synchronize()
        launches.append((tridiag_solve.LAUNCHES - before[0],
                         spd_solve.LAUNCHES - before[1]))
        outs.append((out, cov, it))
    (cpu, cov_c, it_c), (card, cov_g, it_g) = outs
    assert it_g == it_c == 4
    assert launches[1] == ((5, 0) if solver == "chain" else (0, 4))
    assert rel_err(card.cost, cpu.cost) < 1e-8
    for a, b in ((card.poses.t, cpu.poses.t), (card.poses.R, cpu.poses.R),
                 (card.bias, cpu.bias), *zip(cov_g, cov_c)):
        assert rel_err(a, b) < 1e-8


# ---- the geometric-vision slice: the kernels at its shapes ----

@pytest.mark.parametrize("n", [12, 63])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 5e-6),
                                        (torch.float64, 1e-9)])
def test_spd_solve_kernel_at_geometry_sizes(n, dtype, tol):
    """n = 12: the two-view refinement's reduced camera system (2 cameras);
    n = 63 = 9 + 6 x 9: Zhang calibration's normal system at 9 views, a
    ragged second 32-tile."""
    dev = require_cuda()
    S, b = _spd_system(n, dtype, dev)
    before = spd_solve.LAUNCHES
    x = spd_solve.spd_solve(S, b)
    torch.cuda.synchronize()
    assert spd_solve.LAUNCHES == before + 1
    assert rel_err(x, spd_solve.spd_solve_plain(S, b)) < tol


def test_ba_assemble_kernel_at_the_two_view_grid():
    """The two-view refinement's (K = 2, L = 2000) grid of 2 cameras (the
    bench's make_two_view(2000, noise=1e-3, seed=8)), f32, one landmark
    with no live slot: against plain to 1e-4, two launches bitwise
    equal."""
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.pipelines.two_view import two_view_work
    from slam_tricks_tpu_torch.sim import make_two_view

    dev = require_cuda()
    sc = make_two_view(n_points=2000, noise=1e-3, seed=8,
                       dtype=torch.float32, device=dev)
    w = torch.ones(2000, dtype=torch.float32, device=dev)
    w[11] = 0.0
    work = two_view_work(sc.uv1, sc.uv2, w)
    assert work.w.shape == (2, 2000)
    poses = se3.SE3(torch.stack([torch.eye(3, device=dev), sc.T_12.R]),
                    torch.stack([torch.zeros(3, device=dev), sc.T_12.t]))
    points = se3.act(sc.T1, sc.points) * 1.01
    args = (poses.R.reshape(2, 9), poses.t, points, work.uv0, work.uv1,
            work.w, work.cam_of_slot)
    ref = ba_assemble.linearize_assemble_plain(*args)
    one = ba_assemble.linearize_assemble(*args, work.cam_index)
    two = ba_assemble.linearize_assemble(*args, work.cam_index)
    for name, a, b, c in zip(_ASSEMBLE_OUT, one, ref, two):
        assert rel_err(a, b) < 1e-4, (name, rel_err(a, b))
        assert torch.equal(a, c), name


def test_geometry_pipelines_on_cuda_match_cpu():
    """solve_two_view (ba_assemble, spd_solve at n = 12) and calibrate
    (spd_solve at n = 45) in f64 on the card against the CPU path: 1e-8."""
    from slam_tricks_tpu_torch.pipelines import calibration, two_view
    from slam_tricks_tpu_torch.sim import make_calib_scene, make_two_view

    dev = require_cuda()
    outs = []
    for device in ("cpu", dev):
        tv = make_two_view(n_points=60, noise=1e-4, seed=4, device=device)
        cs = make_calib_scene(n_views=6, noise=0.1, seed=9, device=device)
        before = (ba_assemble.LAUNCHES, spd_solve.LAUNCHES)
        res = two_view.solve_two_view(tv.uv1, tv.uv2, refine_iters=6)
        torch.cuda.synchronize()
        mid = (ba_assemble.LAUNCHES, spd_solve.LAUNCHES)
        cal = calibration.calibrate(cs.board_pts, cs.image_pts, max_iters=5)
        torch.cuda.synchronize()
        outs.append((res, cal, mid[0] - before[0], mid[1] - before[1],
                     spd_solve.LAUNCHES - mid[1]))
    (r_c, c_c, *_), (r_g, c_g, n_ba, n_spd_tv, n_spd_cal) = outs
    # one assemble at the start and one a step; one solve a step
    assert 1 <= n_spd_tv <= 6 and n_ba == n_spd_tv + 1
    assert n_spd_cal == c_g.iterations == c_c.iterations
    for a, b in ((r_g.T_12.R, r_c.T_12.R), (r_g.T_12.t, r_c.T_12.t),
                 (r_g.points, r_c.points), (c_g.poses.t, c_c.poses.t),
                 (c_g.final_cost, c_c.final_cost)):
        assert rel_err(a, b) < 1e-8
    assert abs(float(c_g.intrinsics.fx) - float(c_c.intrinsics.fx)) < 1e-6


def _frontend_run(path, device):
    """One front-end path at the CPU tests' sizes in float64 on `device`:
    a tuple of tensors and numbers to hold card against CPU."""
    from slam_tricks_tpu_torch.frontend import (chessboard, direct,
                                                optical_flow, orb)
    from slam_tricks_tpu_torch.manifolds import se2, se3
    from slam_tricks_tpu_torch.ops import image, nms
    from slam_tricks_tpu_torch.pipelines import panorama
    from slam_tricks_tpu_torch.residuals import camera
    from slam_tricks_tpu_torch.sim import distortion, images

    f64 = torch.float64

    def on(a):
        return torch.as_tensor(np.asarray(a), dtype=f64, device=device)

    if path == "FO":
        img = on(images.textured_image(120, 160, seed=1))
        blur = image.gaussian_blur(img, 1.5)
        gx, gy = image.sobel(blur)
        mag = gx * gx + gy * gy
        intr = camera.Intrinsics(80.0, 80.0, 80.0, 60.0)
        dist = camera.DistCoeffs(-0.2, 0.05, 0.01, 1e-3, -2e-3)
        return (blur, gx, gy, mag, *nms.top_k_peaks(mag.cpu(), 200, 4),
                image.undistort_image(img, intr, dist))
    if path == "SD":
        rng = np.random.default_rng(31)
        rs = distortion.rolling_shutter_points(
            on(rng.uniform(0, 400, (64, 2))), on(rng.normal(size=(64, 2))
                                                 * 300), 1e-4)
        sweep = distortion.lidar_sweep(
            distortion.box_segments(4.0, f64, device),
            se2.SE2(on(0.3), on([0.5, -0.2])), on([2.0, -1.0, 3.0]),
            n_beams=361)
        return (rs, *sweep)
    if path == "LK":
        img1 = images.textured_image(seed=1)
        img2 = images.shift_image(img1, 3.4, -2.2)
        pts = optical_flow.grid_seed_points(120, 160, grid=5, pts_per_cell=1,
                                            margin=20, seed=2)
        return optical_flow.lk_track(on(img1), on(img2), on(pts), levels=3,
                                     win=7, iters=15)
    if path == "DA":
        from scipy.ndimage import gaussian_filter

        tex = gaussian_filter(np.random.default_rng(3).normal(
            size=(120, 160)), 3.0)
        img1 = on((tex - tex.min()) / np.ptp(tex))
        T_21 = se3.exp(on([0.05, -0.03, 0.02, 0.004, -0.006, 0.003]))
        ys, xs = torch.meshgrid(torch.arange(120.0, dtype=f64, device=device),
                                torch.arange(160.0, dtype=f64, device=device),
                                indexing="ij")
        p2 = torch.stack([(xs - 80) / 150 * 5, (ys - 60) / 150 * 5,
                          torch.full_like(xs, 5.0)], -1).reshape(-1, 3)
        p1 = se3.act(se3.inv(T_21), p2)
        img2 = image.sample_bilinear(img1, torch.stack(
            [150 * p1[:, 0] / p1[:, 2] + 80, 150 * p1[:, 1] / p1[:, 2] + 60],
            1)).reshape(120, 160)
        T_est, res = direct.direct_pose_estimate(
            img1, img2, torch.full((256,), 5.0, dtype=f64, device=device),
            camera.Intrinsics(150.0, 150.0, 80.0, 60.0), k=256, max_iters=40)
        return T_est.R, T_est.t, res.cost
    if path == "ORB":
        img = images.polygon_image(seed=3)
        rot, _ = images.rotate_image(img, 30.0)
        f1 = orb.orb_detect(on(img), n=300)
        f2 = orb.orb_detect(on(rot), n=300)
        return f1, f2, orb.orb_match(f1, f2, ratio=0.8, max_hamming=48)
    if path == "CB":
        img, _ = images.render_chessboard(rows=5, cols=7, square_px=20,
                                          margin=20, angle=0.15, noise=0.01)
        return chessboard.detect_chessboard(img.astype(np.float64), k=96,
                                            device=device)
    if path == "PAN":
        img1 = images.textured_image(h=140, w=180, seed=4)
        img2 = images.shift_image(img1, -12.0, -5.0)
        g = torch.Generator(device=device).manual_seed(0)
        return panorama.pairwise_homography(g, on(img1), on(img2))
    raise ValueError(path)


@pytest.mark.parametrize("path", ["FO", "SD", "LK", "DA", "ORB", "CB", "PAN"])
def test_frontend_path_on_cuda_matches_cpu(path):
    """The front end's paths (no kernel) in f64 on the card against the
    CPU at the CPU tests' sizes: arrays to 1e-9 relative (LK's points and
    DA's pose 1e-8), top-k peaks, masks and boards equal; ORB's keypoints
    as a set, descriptor bits at most 0.5% apart; PAN's H (different
    random subsets, one consensus) to 1e-6. No kernel launches."""
    dev = require_cuda()
    counts = [m.LAUNCHES for m in (ba_assemble, spd_solve, tridiag_solve,
                                   undistort)]
    card = _frontend_run(path, dev)
    torch.cuda.synchronize()
    assert counts == [m.LAUNCHES for m in (ba_assemble, spd_solve,
                                           tridiag_solve, undistort)]
    cpu = _frontend_run(path, torch.device("cpu"))
    if path == "ORB":
        (g1, g2, (gi, gok)), (c1, c2, (ci, cok)) = card, cpu
        for g, c in ((g1, c1), (g2, c2)):
            key = {tuple(p): i for i, p in enumerate(c.xy.long().tolist())}
            gv = g.valid.cpu()
            assert int(gv.sum()) == int(c.valid.sum()) > 80
            rows = [key[tuple(p)] for p, v in zip(g.xy.long().tolist(), gv)
                    if v]
            assert rel_err(g.angle.cpu()[gv], c.angle[rows]) < 1e-9
            assert (g.desc.cpu()[gv] != c.desc[rows]).double().mean() < 5e-3
        assert abs(int(gok.sum()) - int(cok.sum())) <= 2
        return
    if path == "CB":
        (gb, gxy, gsc, _), (cb_, cxy, csc, _) = card, cpu
        assert [b.shape for b in gb] == [b.shape for b in cb_] != []
        assert torch.equal(torch.isfinite(gsc.cpu()), torch.isfinite(csc))
        for b, c in zip(gb, cb_):
            assert rel_err(gxy.cpu()[b], cxy[c]) < 1e-9
        return
    if path == "PAN":
        (gH, gn), (cH, cn) = card, cpu
        assert int(gn) == int(cn) > 15
        assert float((gH.cpu() - cH).abs().max()) < 1e-6
        return
    for a, b in zip(card, cpu):
        if a.dtype == torch.bool or not a.is_floating_point():
            assert torch.equal(a.cpu(), b)
        else:
            a, fin = a.cpu(), torch.isfinite(b)
            assert torch.equal(torch.isfinite(a), fin)
            assert rel_err(a[fin], b[fin]) < (1e-8 if path in ("LK", "DA")
                                              else 1e-9)


# ---- slice H: the host utilities and the example programs on the card ----

def test_timer_lap_waits_for_queued_work():
    """Timer.lap(sync=out) reads the clock only after out's device is done:
    it is at least the CUDA events' time around the same products, while a
    lap without sync reads only the queueing."""
    from slam_tricks_tpu_torch.utils.timer import Timer

    dev = require_cuda()
    a = torch.ones((8192, 8192), device=dev)
    (a @ a).sum().item()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t, t_nosync = Timer(), Timer()
    start.record()
    out = [a @ a for _ in range(8)][-1]
    end.record()
    queued_ms = t_nosync.lap("queued") * 1e3
    lap_ms = t.lap("products", sync=out) * 1e3
    event_ms = start.elapsed_time(end)
    assert event_ms * 0.9 <= lap_ms <= event_ms * 1.1 + 5.0
    assert queued_ms < 0.5 * event_ms


def test_checkpoint_of_cuda_tensors_loads_onto_cuda(tmp_path):
    """save_pytree of a BAState on the card; load_pytree into a like on the
    card gives the same bits there, into a like on the CPU the same bits on
    the CPU."""
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.solvers.common import tree_map
    from slam_tricks_tpu_torch.solvers.schur import BAState
    from slam_tricks_tpu_torch.utils.checkpoint import (load_pytree,
                                                        save_pytree,
                                                        tree_leaves)

    dev = require_cuda()
    g = torch.Generator(device="cpu").manual_seed(0)
    state = BAState(poses=se3.exp(torch.randn(4, 6, generator=g)),
                    points=torch.randn(5, 3, generator=g), cost=torch.tensor(
                        0.5), lam=torch.tensor(1e-4), nu=torch.tensor(2.0),
                    it=7, done=False)
    on_card = tree_map(lambda x: x.to(dev), state)
    path = save_pytree(str(tmp_path / "state.npz"), on_card)
    for like in (on_card, state):
        back = load_pytree(path, like)
        for a, b in zip(tree_leaves(on_card), tree_leaves(back)):
            if isinstance(a, torch.Tensor):
                assert b.device == tree_leaves(like)[0].device
                assert torch.equal(a.cpu(), b.cpu())
            else:
                assert a == b


def test_example_runs_on_cuda_by_default():
    """An example without --cpu runs on the card (float32), with --cpu on
    the CPU (float64), and the two agree."""
    from slam_tricks_tpu_torch.examples import two_view_demo

    require_cuda()
    card = two_view_demo.main([])
    cpu = two_view_demo.main(["--cpu"])
    assert card["n_cheiral"] == cpu["n_cheiral"] == 100
    for k in ("rot_err", "t_err", "final_cost"):
        assert abs(card[k] - cpu[k]) <= 5e-3 * abs(cpu[k])


# ---- the distributed solvers: two gloo ranks that share the card ----

def _dist_case(name):
    """(make, kwargs, args on the CPU) of a small f64 problem: banded_dist
    on the 16-camera trajectory of tests/test_multihost.py, sharded_ba on
    the noisy cube room of tests/test_landmark_local.py (4 iterations, off
    the f64 floor)."""
    from slam_tricks_tpu_torch.parallel import banded_dist, partition, sharded_ba

    f64 = torch.float64
    if name == "banded_dist":
        sc = make_trajectory_scene(n_cams=16, n_points=240, track_len=4,
                                   seed=73, dtype=f64, device="cpu")
        poses0, points0, fixed = perturb_scene(sc, seed=74)
        work = banded_dist.build_dist_banded_work(sc.obs, 16, 240, 2,
                                                  dtype=f64)
        return (banded_dist.make_ba_solver_banded_dist, dict(max_iters=8),
                (poses0, points0, work, fixed))
    sc = make_scene(n_per_wall=10, n_cams=6, seed=51, pix_noise=1e-3,
                    dtype=f64, device="cpu")
    poses0, points0, fixed = perturb_scene(sc, seed=52)
    obs = partition.partition_obs_by_landmark(sc.obs, 2)
    pairs = partition.build_local_pairs(obs, 2, dtype=f64)
    return (sharded_ba.make_ba_solver, dict(max_iters=4),
            (poses0, points0, obs, pairs, fixed))


def _dist_rank(rank, world, tmpdir, name):
    """A rank (a spawned process): the case's solve on the CPU and on the
    card over one gloo group; (it, R, t, points, cost) of each, by device,
    to tmpdir/rank<rank>.pt, a traceback to rank<rank>.err."""
    import traceback

    import torch.distributed as dist

    from slam_tricks_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize_multihost(f"file://{tmpdir}/store", world, rank,
                                   timeout_s=120.0)
    try:
        make, kw, args = _dist_case(name)
        out = {}
        for device in ("cpu", "cuda"):
            state = make(None, **kw)(*multihost.make_global_array(
                args, None, device))
            out[device] = (state.it, state.poses.R.cpu(), state.poses.t.cpu(),
                           state.points.cpu(), state.cost.cpu())
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    except BaseException:
        with open(f"{tmpdir}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["banded_dist", "sharded_ba"])
def test_distributed_solver_on_two_ranks_on_cuda_matches_cpu(name, tmp_path):
    """Two ranks on cuda:0 (gloo: NCCL refuses two ranks on one device),
    the kernels launched inside them: the ranks return the same bits, and
    the card's solve is the CPU's to 1e-8 in the poses and the points."""
    import torch.multiprocessing as mp

    require_cuda()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, 2, str(tmp_path), name))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [e.read_text() for e in sorted(tmp_path.glob("rank*.err"))]
    assert not any(alive) and not errors, (alive, errors)
    assert [p.exitcode for p in procs] == [0, 0]
    out = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    for a, b in zip(out[0]["cuda"], out[1]["cuda"]):
        assert (a == b if isinstance(a, int) else torch.equal(a, b))
    card, cpu = out[0]["cuda"], out[0]["cpu"]
    assert card[0] == cpu[0]
    for a, b in zip(card[1:4], cpu[1:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(card[4]), float(cpu[4]), rtol=1e-7)


# ---- the graphed LM loop (schur.lm_graphed) against the eager one ----

def _graph_case(path, dtype, dev, n_cams=None):
    """(scene, work, fixed, graphed(poses0, points0, costs=None, fixed=,
    iters=8), eager(poses0, points0, costs, iters=8)): path A's solve (16
    cameras) or path B's (a 32-camera trajectory), 8 LM iterations unless
    `iters` says otherwise; the eager one is
    ``schur.lm_loop`` over the same solver's steps, as the solver ran it
    before its graphs existed."""
    if path == "A":
        sc = make_scene(n_per_wall=60, n_cams=n_cams or 16, seed=3,
                        dtype=dtype, device=dev)
        work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                             dtype=dtype)
        fixed = perturb_scene(sc, seed=4)[2]

        def graphed(p, x, costs=None, fixed=fixed, iters=8):
            return schur_flat_sm.solve_ba_flat_sm(
                p, x, work, fixed_mask=fixed, max_iters=iters, costs=costs)

        def eager(p, x, costs, iters=8):
            return schur.lm_loop(
                p, x, lambda P, X: schur_flat_sm._quantities_sm(P, X, work),
                lambda b, lam: schur_flat_sm._solve_sm(*b, lam, fixed, work),
                max_iters=iters, costs=costs)
    else:
        sc = make_trajectory_scene(n_cams=n_cams or 32, n_points=600,
                                   track_len=6, seed=71, pix_noise=1e-3,
                                   dtype=dtype, device=dev)
        work = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                             dtype=dtype)
        fixed = perturb_scene(sc, seed=72)[2]

        def graphed(p, x, costs=None, fixed=fixed, iters=8):
            return banded_flat.solve_ba_banded(
                p, x, work, fixed_mask=fixed, max_iters=iters, costs=costs)

        def eager(p, x, costs, iters=8):
            out = schur.lm_loop(
                p, x[work.gather_idx],
                lambda P, X: banded_flat._banded_quantities(P, X, work),
                lambda b, lam: banded_flat._solve_banded(*b, lam, fixed,
                                                         work),
                max_iters=iters, costs=costs)
            return out._replace(points=banded_flat.scatter_slots(
                x, out.points, work.scatter_idx))
    return sc, work, fixed, graphed, eager


def _start(path, sc, seed):
    if path == "A":
        return perturb_scene(sc, seed=seed)[:2]
    return perturb_scene(sc, pose_rot_noise=0.002, pose_trans_noise=0.01,
                         point_noise=0.01, seed=seed)[:2]


def _state(out):
    return (out.poses.R, out.poses.t, out.points, out.cost, out.lam, out.nu)


def _counters():
    return (schur.GRAPH_CAPTURES, schur.GRAPH_REPLAYS,
            schur.EAGER_ITERATIONS)


@pytest.mark.parametrize("path", ["A", "B"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graphed_solve_has_the_eager_loops_bits(path, dtype):
    """The capturing solve and a warm one give the eager loop's final
    state, cost, iterations and costs, bit for bit."""
    dev = require_cuda()
    sc, work, fixed, graphed, eager = _graph_case(path, dtype, dev)
    poses0, points0 = _start(path, sc, 4 if path == "A" else 72)
    ref_costs = []
    ref = eager(poses0, points0, ref_costs)
    for _ in range(2):
        costs = []
        out = graphed(poses0, points0, costs)
        assert (out.it, out.done) == (ref.it, ref.done) and out.it >= 2
        for a, b in zip(_state(out), _state(ref)):
            assert torch.equal(a, b)
        assert len(costs) == len(ref_costs) == out.it + 1
        assert all(torch.equal(a, b) for a, b in zip(costs, ref_costs))


@pytest.mark.parametrize("path", ["A", "B"])
def test_graphed_solve_outputs_are_their_own(path):
    """A second solve from another start leaves the first one's returned
    tensors and costs as they were."""
    dev = require_cuda()
    sc, work, fixed, graphed, _ = _graph_case(path, torch.float32, dev)
    costs = []
    first = graphed(*_start(path, sc, 5), costs)
    kept = [t.clone() for t in _state(first) + tuple(costs)]
    second = graphed(*_start(path, sc, 6))
    assert not torch.equal(second.poses.t, first.poses.t)
    for a, b in zip(_state(first) + tuple(costs), kept):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", ["A", "B"])
def test_graphed_solve_captures_once_a_layout(path):
    """Four graphs on a layout's first solve, none on the next; another
    fixed mask or another layout captures anew."""
    dev = require_cuda()
    sc, work, fixed, graphed, _ = _graph_case(path, torch.float32, dev)
    start = _start(path, sc, 7)
    c0 = _counters()
    first = graphed(*start)
    c1 = _counters()
    assert c1[0] - c0[0] == 4
    assert c1[1] - c0[1] == 4 * (first.it - 1) and c1[2] - c0[2] == 1
    out = graphed(*start)
    c2 = _counters()
    assert (c2[0] - c1[0], c2[1] - c1[1], c2[2] - c1[2]) == (0, 4 * out.it, 0)
    other = fixed.clone()
    other[-1] = True
    graphed(*start, fixed=other)
    c3 = _counters()
    assert c3[0] - c2[0] == 4
    sc2, _, fixed2, graphed2, _ = _graph_case(path, torch.float32, dev,
                                              n_cams=12 if path == "A" else 24)
    graphed2(*_start(path, sc2, 8))
    assert _counters()[0] - c3[0] == 4


@pytest.mark.parametrize("path", ["A", "B"])
def test_graphed_solve_of_one_iteration_captures_nothing(path):
    """A layout's solve that stops after one iteration runs it eagerly, the
    eager loop's bits, and captures nothing; the layout's next solve of
    more iterations captures its four graphs."""
    dev = require_cuda()
    sc, work, fixed, graphed, eager = _graph_case(path, torch.float32, dev)
    start = _start(path, sc, 10)
    schur.release_graphs()
    c0 = _counters()
    ref_costs, costs = [], []
    ref = eager(*start, ref_costs, iters=1)
    out = graphed(*start, costs, iters=1)
    c1 = _counters()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (0, 0, 2)
    assert (out.it, out.done) == (ref.it, ref.done) == (1, False)
    for a, b in zip(_state(out) + tuple(costs), _state(ref) + tuple(ref_costs)):
        assert torch.equal(a, b)
    more = graphed(*start)
    c2 = _counters()
    assert more.it >= 2 and c2[0] - c1[0] == 4 and c2[2] - c1[2] == 1


@pytest.mark.parametrize("path", ["A", "B"])
def test_release_graphs_drops_the_layout(path):
    """``schur.release_graphs()`` frees the cache's entry, which holds the
    layout, and the layout's next solve captures anew."""
    import gc
    import weakref

    dev = require_cuda()
    sc, work, fixed, graphed, _ = _graph_case(path, torch.float32, dev)
    start = _start(path, sc, 11)
    graphed(*start)
    entry = weakref.ref(schur._GRAPHS[0])
    assert entry().key.held[0] is work
    schur.release_graphs()
    gc.collect()
    assert schur._GRAPHS == [None] and entry() is None
    c0 = _counters()
    graphed(*start)
    assert _counters()[0] - c0[0] == 4


@pytest.mark.parametrize("path", ["A", "B"])
def test_new_layouts_reuse_one_graph_pool(path):
    """A new layout every solve, each evicting the last one's graphs,
    reserves no more device memory after the tenth than after the fifth:
    every layout's graphs share one pool."""
    dev = require_cuda()
    sc, _, fixed, _, _ = _graph_case(path, torch.float32, dev)
    start = _start(path, sc, 12)
    build, solve = ((schur_flat_sm.build_slot_work,
                     schur_flat_sm.solve_ba_flat_sm) if path == "A" else
                    (banded_flat.build_banded_work,
                     banded_flat.solve_ba_banded))
    c0, reserved = _counters(), []
    for _ in range(10):
        work = build(sc.obs, sc.n_cams, sc.n_points, dtype=torch.float32)
        solve(*start, work, fixed_mask=fixed, max_iters=4)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
    assert _counters()[0] - c0[0] == 40
    assert reserved[-1] <= reserved[4], reserved


@pytest.mark.parametrize("path", ["A", "B"])
def test_graphed_solve_syncs_once_an_iteration(path):
    """A warm graphed solve waits for the device once an iteration (the
    stop flag), and path B twice more a solve (``scatter_slots``' mask)."""
    import warnings

    dev = require_cuda()
    sc, work, fixed, graphed, _ = _graph_case(path, torch.float32, dev)
    start = _start(path, sc, 9)
    graphed(*start)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = graphed(*start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == out.it + (0 if path == "A" else 2), [
        str(w.message) for w in syncs]


# ---- BAL's 9-parameter cameras (solvers/schur_bal.py) ----

def _bal_problem(dtype, dev, n_cams=12, n_points=400, n_obs=1600, seed=3):
    """(cameras0, points0, fixed, work) of a small generated BAL scene
    (``benchmark/scenes/bal_city.py``) from a seeded start."""
    from benchmark.harness import scenes
    from benchmark.scenes import bal_city
    from slam_tricks_tpu_torch.residuals import bal
    from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
    from slam_tricks_tpu_torch.solvers import schur_bal
    spec = dict(n_cams=n_cams, n_points=n_points, n_observations=n_obs,
                seed=seed, max_track=n_cams)
    sc = bal_city.make(**spec)
    f64 = torch.float64
    fixed = torch.as_tensor(scenes.fixed_mask(n_cams, "first_last"),
                            device=dev)
    R, t, X = scenes.perturbed_start(
        torch.as_tensor(sc.R, dtype=f64, device=dev),
        torch.as_tensor(sc.t, dtype=f64, device=dev),
        torch.as_tensor(sc.points, dtype=f64, device=dev), fixed,
        {"rot": 0.002, "trans": 0.02, "point": 0.02}, seed + 1)
    gen = torch.Generator().manual_seed(seed + 2)
    K = torch.as_tensor(bal_city.intrinsics(**spec), dtype=f64)
    K = K + torch.randn(K.shape, generator=gen, dtype=f64) * torch.tensor(
        [1.0, 0.002, 0.0005], dtype=f64) * (~fixed.cpu())[:, None]
    obs = BAObservations(
        cam_idx=torch.as_tensor(sc.cam.astype(np.int32), device=dev),
        lm_idx=torch.as_tensor(sc.lm.astype(np.int32), device=dev),
        uv=torch.as_tensor(sc.uv, dtype=dtype, device=dev),
        weight=torch.ones(sc.cam.shape[0], dtype=dtype, device=dev))
    work = schur_bal.build_bal_work(obs, n_cams, n_points, dtype=dtype)
    cams = bal.BALCameras(R.to(dtype), t.to(dtype), K.to(dtype).to(dev))
    return cams, X.to(dtype), fixed, work


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-10)])
def test_ba_assemble9_kernel_matches_plain(dtype, tol):
    """The 9-wide kernel over a problem's bucket grids, the camera sums
    added grid after grid, against the plain version on the CPU; two
    launches give the same bits."""
    from slam_tricks_tpu_torch.ops.ba_assemble import (
        linearize_assemble_grids)
    dev = require_cuda()
    cams, X, _, work = _bal_problem(dtype, dev)
    pts = X[work.perm]
    args = (cams.R.reshape(-1, 9).contiguous(), cams.t, cams.intr, pts)
    got = linearize_assemble_grids(*args, work.grids)
    again = linearize_assemble_grids(*args, work.grids)
    cpu = [g._replace(uv0=g.uv0.cpu(), uv1=g.uv1.cpu(), w=g.w.cpu(),
                      cam_of_slot=g.cam_of_slot.cpu(), cam_index=None)
           for g in work.grids]
    ref = linearize_assemble_grids(*(a.cpu() for a in args), cpu)
    assert len(work.grids) >= 3
    for a, b, c in zip(got[:4] + (got[5],), ref[:4] + (ref[5],),
                       again[:4] + (again[5],)):
        assert rel_err(a, b) < tol
        assert torch.equal(a, c)
    for a, b, c in zip(got[4], ref[4], again[4]):
        assert rel_err(a, b) < tol
        assert torch.equal(a, c)


def test_graphed_bal_solve_has_the_eager_loops_bits():
    """Two graphed f32 BAL solves give the eager loop's final cameras,
    points, cost and costs, bit for bit; the reduced system is three
    graphs, so a layout's first solve captures six."""
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.solvers import schur_bal
    dev = require_cuda()
    cams, X, fixed, work = _bal_problem(torch.float32, dev)
    ref_costs = []
    ref = schur.lm_loop(
        cams, X[work.perm],
        lambda c, x: schur_bal._quantities(c, x, work),
        lambda b, lam: schur_bal._solve(b, lam, fixed, work),
        max_iters=6, costs=ref_costs)
    schur.release_graphs()
    c0 = _counters()
    for _ in range(2):
        costs = []
        out = schur_bal.solve_bal(se3.SE3(cams.R, cams.t), cams.intr, X,
                                  work, fixed_mask=fixed, max_iters=6,
                                  costs=costs)
        assert out.it == ref.it >= 2
        for a, b in zip(tuple(out.poses) + (out.points, out.cost),
                        tuple(ref.poses) + (ref.points[work.inv], ref.cost)):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(costs, ref_costs))
    assert _counters()[0] - c0[0] == 6
