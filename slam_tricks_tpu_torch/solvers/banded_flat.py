"""Slot-major banded-direct BA, the large-C trajectory solve (port of
``slam_tricks_tpu/solvers/banded_flat.py``, the solve path).

Each landmark is seen by a run of at most K consecutive cameras starting at
c0(l). Observations live on a (K, Lpad) slot grid: slot k of landmark l is
its observation by camera c0(l) + k, weight 0 if there is none. Landmarks
are sorted by c0 and each c0 group is padded to a multiple of `chunk`, so
every chunk of `chunk` landmarks shares one c0. The reduced camera system
S has bandwidth K - 1; grouping cameras into super-blocks of Kb = max(K, 2)
makes it exactly block-tridiagonal in (G, 6 Kb, 6 Kb) blocks, which
``ops/tridiag_solve`` (a CUDA kernel on the card) solves exactly.

One LM iteration:

1. linearize + assemble on the slot grid (``ops/ba_assemble``, the CUDA
   kernel of the headline solve; camera c0 + k of a padding slot wraps
   modulo C, its weight is 0);
2. the band blocks S[c + o, c] by chunk sums and ``index_add_`` at the
   chunk's camera, damping and gauge, the super-block grouping;
3. the block-tridiagonal solve and the landmark back-substitution;
4. retract, accept or reject: ``schur.lm_loop``.

The math is the JAX package's. Where the JAX code multiplies by the
(chunks, C) one-hot and rolls rows so that the TPU never gathers, the port
keeps each chunk's c0 as an integer and gathers and adds at c0 + k.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_tricks_tpu_torch.ops.ba_assemble import (CameraIndex, layout_index,
                                                   linearize_assemble)
from slam_tricks_tpu_torch.ops.tridiag_solve import tridiag_solve
from slam_tricks_tpu_torch.solvers.common import set_full_precision
from slam_tricks_tpu_torch.solvers.schur import lm_loop
from slam_tricks_tpu_torch.solvers.schur_flat_sm import (_DIAG3, _DIAG6,
                                                         _inv3x3_flat,
                                                         _sym6_expand)

_SYM33 = [0, 1, 2, 1, 3, 4, 2, 4, 5]     # (3, 3) entries of 6 upper-triangle


class BandedWork(NamedTuple):
    """Host-built slot-major layout of a trajectory problem, on the
    observations' device."""
    uv0: torch.Tensor          # (K, Lpad) measured u
    uv1: torch.Tensor          # (K, Lpad) measured v
    w: torch.Tensor            # (K, Lpad) weights, 0 = no observation
    cam_of_slot: torch.Tensor  # (K, Lpad) int32, (c0 + k) mod C
    cam_index: Optional[CameraIndex]  # the kernel's sums; None on the CPU
    c0: torch.Tensor           # (Lpad / chunk,) int64 first camera of a chunk
    scatter_idx: torch.Tensor  # (Lpad,) int64 landmark id, n_points = padding
    gather_idx: torch.Tensor   # (Lpad,) int64 scatter_idx clipped to [0, L)
    n_cams: int
    n_points: int

    @property
    def chunk(self):
        return self.w.shape[1] // self.c0.shape[0]


def build_banded_work(obs, n_cams, n_points, dtype=torch.float32, chunk=32,
                      max_band=32):
    """Check the trajectory structure and build the slot-major layout, in
    numpy on the host; the landmark order, padding and indices are the JAX
    package's. Raises ValueError for a duplicate (landmark, camera)
    observation or a band K > max_band."""
    device = obs.uv.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cam = obs.cam_idx.cpu().numpy().astype(np.int64)
    lm = obs.lm_idx.cpu().numpy().astype(np.int64)
    uv = obs.uv.cpu().numpy()
    w = obs.weight.cpu().numpy()
    C, L = int(n_cams), int(n_points)
    valid = np.flatnonzero(w > 0)
    cam_v, lm_v = cam[valid], lm[valid]

    key = lm_v * C + cam_v
    if np.unique(key).shape[0] != key.shape[0]:
        raise ValueError("duplicate (landmark, camera) observation")
    c0 = np.full(L, C, np.int64)
    cmax = np.full(L, -1, np.int64)
    np.minimum.at(c0, lm_v, cam_v)
    np.maximum.at(cmax, lm_v, cam_v)
    observed = cmax >= 0
    span = np.where(observed, cmax - c0 + 1, 1)
    K = int(span.max()) if observed.any() else 1
    if K > max_band:
        raise ValueError(f"band {K} > max_band {max_band}")
    c0 = np.where(observed, c0, 0)

    # landmarks sorted by c0, each c0 group padded to a multiple of `chunk`
    obs_lms = np.flatnonzero(observed)
    order = obs_lms[np.argsort(c0[obs_lms], kind="stable")]
    counts = np.bincount(c0[order], minlength=C)
    padded = counts + (-counts) % chunk
    Lpad = max(int(padded.sum()), chunk)
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(padded, out=starts[1:])
    gstart = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=gstart[1:])
    pos = starts[c0[order]] + (np.arange(order.shape[0]) - gstart[c0[order]])

    scatter_idx = np.full(Lpad, L, np.int64)
    scatter_idx[pos] = order
    slot_c0 = np.zeros(Lpad, np.int64)
    slot_c0[:int(padded.sum())] = np.repeat(np.arange(C), padded)
    chunk_c0 = slot_c0.reshape(-1, chunk)[:, 0]

    uvg = np.zeros((K, 2, Lpad), np_dtype)
    wg = np.zeros((K, Lpad), np_dtype)
    lm_slot = np.full(L, Lpad, np.int64)
    lm_slot[scatter_idx[pos]] = pos
    k_of = cam_v - c0[lm_v]
    col = lm_slot[lm_v]
    uvg[k_of, 0, col] = uv[valid, 0].astype(np_dtype)
    uvg[k_of, 1, col] = uv[valid, 1].astype(np_dtype)
    wg[k_of, col] = w[valid].astype(np_dtype)
    cam_of_slot = (slot_c0[None, :] + np.arange(K)[:, None]) % C

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    w_t, cam_t = tensor(wg), tensor(cam_of_slot.astype(np.int32))
    return BandedWork(
        uv0=tensor(uvg[:, 0]), uv1=tensor(uvg[:, 1]), w=w_t,
        cam_of_slot=cam_t, cam_index=layout_index(w_t, cam_t, C),
        c0=tensor(chunk_c0),
        scatter_idx=tensor(scatter_idx),
        gather_idx=tensor(np.minimum(scatter_idx, L - 1)),
        n_cams=C, n_points=L)


def _banded_quantities(poses, points_s, bw: BandedWork):
    """Linearize + assemble on the slot grid: (Hpp (C, 21), gp (C, 6),
    Hll (6, Lpad), gl (3, Lpad), W (18, K, Lpad)), cost."""
    C = bw.n_cams
    Hpp, gp, Hll, gl, W, cost = linearize_assemble(
        poses.R.reshape(C, 9), poses.t, points_s, bw.uv0, bw.uv1, bw.w,
        bw.cam_of_slot, bw.cam_index)
    return (Hpp, gp, Hll, gl, W), cost


def _chunk_cams(bw: BandedWork, K):
    """(K, chunks) camera c0 + k of each chunk, modulo C."""
    k = torch.arange(K, device=bw.c0.device)[:, None]
    return (bw.c0[None, :] + k) % bw.n_cams


def _cam_sum(cols, cams, C):
    """Per-camera sums of slot columns: cols (n, k, Lpad), cams (k, chunks)
    -> (C, n). Sums each chunk first, then adds it at its camera."""
    n, k, Lpad = cols.shape
    part = cols.reshape(n, k, cams.shape[1], Lpad // cams.shape[1]).sum(-1)
    out = torch.zeros((C, n), dtype=cols.dtype, device=cols.device)
    return out.index_add_(0, cams.reshape(-1), part.reshape(n, -1).T)


def _mat3vec(h, v):
    """Symmetric 3x3 blocks (6, Lpad) times vectors (3, Lpad) -> (3, Lpad)."""
    H = h[_SYM33].view(3, 3, -1)
    return H[:, 0] * v[0] + H[:, 1] * v[1] + H[:, 2] * v[2]


def _assemble_bands(Hpp, Hll, W, lam, fixed_mask, bw: BandedWork):
    """Damped, gauge-fixed band blocks S[c + o, c] of the reduced camera
    system, bands (K, C, 6, 6), and the landmark inverse hinv (6, Lpad), the
    Marquardt diagonals dpp (C, 6), dll (3, Lpad) and free (C,)."""
    dtype, device = Hpp.dtype, Hpp.device
    C = bw.n_cams
    K = W.shape[1]
    cams = _chunk_cams(bw, K)

    dpp = torch.clamp_min(Hpp[:, _DIAG6], 1e-12)
    dll = torch.clamp_min(Hll[_DIAG3], 1e-12)
    Hpp_d = _sym6_expand(Hpp) + torch.diag_embed(lam * dpp)
    empty = (Hll[0] + Hll[3] + Hll[5]) <= 0.0
    damp = torch.zeros_like(Hll)
    damp[_DIAG3] = lam * dll
    eye3 = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], dtype=dtype,
                        device=device)[:, None]
    hinv = torch.stack(_inv3x3_flat(torch.where(empty, eye3, Hll + damp)))

    # Y(k) = W(k) Hll^-1, (6, 3, K, Lpad)
    W3 = W.view(6, 3, K, -1)
    H = hinv[_SYM33].view(3, 3, -1)
    Y = (W3[:, 0, None] * H[0][None, :, None] + W3[:, 1, None] * H[1][None, :, None]
         + W3[:, 2, None] * H[2][None, :, None])
    # band o: -sum over slots k of Y(k + o) W(k)^T, at camera c0 + k
    bands = []
    for o in range(K):
        prod = (Y[:, 0, None, o:] * W3[None, :, 0, :K - o]
                + Y[:, 1, None, o:] * W3[None, :, 1, :K - o]
                + Y[:, 2, None, o:] * W3[None, :, 2, :K - o])   # (6, 6, K-o, Lpad)
        bands.append(-_cam_sum(prod.reshape(36, K - o, -1), cams[:K - o], C))
    bands = torch.stack(bands).view(K, C, 6, 6)
    bands[0] += Hpp_d

    # gauge: zero rows and columns of fixed cameras, unit diagonal; rows
    # c >= C - o of band o are padding (S[c + o, c] needs c + o < C)
    free = (~fixed_mask).to(dtype)
    c = torch.arange(C, device=device)
    o = torch.arange(K, device=device)[:, None]
    keep = free[(c + o) % C] * free * (c < C - o).to(dtype)       # (K, C)
    bands = bands * keep[:, :, None, None]
    bands[0] += torch.eye(6, dtype=dtype, device=device) * (1.0 - free)[:, None, None]
    return bands, hinv, dpp, dll, free


def _group_superblocks(bands, C):
    """Band blocks (K, C, 6, 6) -> the super-block tridiagonal: Dm (G, m, m),
    Em (G-1, m, m), with m = 6 Kb, Kb = max(K, 2), the cameras padded to
    G Kb by identity diagonal blocks. Returns (Dm, Em, Kb)."""
    K = bands.shape[0]
    dtype, device = bands.dtype, bands.device
    Kb = max(K, 2)
    G = -(-C // Kb)
    Cp = G * Kb
    B = torch.zeros((Kb, Cp, 6, 6), dtype=dtype, device=device)
    B[:K, :C] = bands
    B[0, C:] = torch.eye(6, dtype=dtype, device=device)
    B = B.view(Kb, G, Kb, 6, 6)

    # diagonal super-block g: (r + o, r) <- band o at camera g Kb + r, and
    # its transpose at (r, r + o); sub-diagonal: rows past Kb spill over
    lo = [(o, r) for o in range(Kb) for r in range(Kb - o)]
    up = [(o, r) for o, r in lo if o > 0]
    sub = [(o, r) for o in range(1, Kb) for r in range(Kb - o, Kb)]
    Dg = torch.zeros((G, Kb, Kb, 6, 6), dtype=dtype, device=device)
    oi, ri = map(list, zip(*lo))
    Dg[:, [o + r for o, r in lo], ri] = B[oi, :, ri].transpose(0, 1)
    oi, ri = map(list, zip(*up))
    Dg[:, ri, [o + r for o, r in up]] = B[oi, :, ri].transpose(0, 1).transpose(-1, -2)
    Dm = Dg.permute(0, 1, 3, 2, 4).reshape(G, 6 * Kb, 6 * Kb)
    Eg = torch.zeros((G - 1, Kb, Kb, 6, 6), dtype=dtype, device=device)
    if G > 1:
        oi, ri = map(list, zip(*sub))
        Eg[:, [o + r - Kb for o, r in sub], ri] = (
            B[oi, :-1, ri].transpose(0, 1))
    Em = Eg.permute(0, 1, 3, 2, 4).reshape(G - 1, 6 * Kb, 6 * Kb)
    return Dm.contiguous(), Em.contiguous(), Kb


def reduced_camera_system(Hpp, gp, Hll, gl, W, lam, fixed_mask,
                          bw: BandedWork):
    """The damped, gauge-fixed reduced camera system as a super-block
    tridiagonal: (Dm (G, m, m), Em (G-1, m, m), rm (G, m), hinv (6, Lpad),
    dpp (C, 6), dll (3, Lpad), free (C,)); the last four are what the
    back-substitution and the LM step need."""
    C = bw.n_cams
    K = W.shape[1]
    bands, hinv, dpp, dll, free = _assemble_bands(Hpp, Hll, W, lam,
                                                  fixed_mask, bw)
    # rhs: b = -(gp - W Hll^-1 gl), zero on the padding cameras
    W3 = W.view(6, 3, K, -1)
    u = _mat3vec(hinv, gl)
    y = W3[:, 0] * u[0, None] + W3[:, 1] * u[1, None] + W3[:, 2] * u[2, None]
    b = -(gp - _cam_sum(y, _chunk_cams(bw, K), C)) * free[:, None]
    Dm, Em, Kb = _group_superblocks(bands, C)
    rm = torch.zeros((Dm.shape[0] * Kb, 6), dtype=b.dtype, device=b.device)
    rm[:C] = b
    return Dm, Em, rm.view(Dm.shape[:2]), hinv, dpp, dll, free


def _solve_banded(Hpp, gp, Hll, gl, W, lam, fixed_mask, bw: BandedWork):
    """Damped, gauge-fixed exact solve of the reduced camera system by the
    super-block tridiagonal solve, then the landmark back-substitution.
    Returns (dp (C, 6), dl (Lpad, 3), diag_pp (C, 6), diag_ll (Lpad, 3))."""
    C = bw.n_cams
    K = W.shape[1]
    Dm, Em, rm, hinv, dpp, dll, free = reduced_camera_system(
        Hpp, gp, Hll, gl, W, lam, fixed_mask, bw)
    dp = tridiag_solve(Dm, Em, rm).reshape(-1, 6)[:C]

    # landmarks: dl = Hll^-1 (-gl - sum_k W(k)^T dp[c0 + k])
    dpn = (dp * free[:, None]).T[:, bw.cam_of_slot.long()]      # (6, K, Lpad)
    t = (W.view(6, 3, K, -1) * dpn[:, None]).sum(dim=(0, 2))    # (3, Lpad)
    dl = _mat3vec(hinv, -gl - t).T
    return dp, dl, dpp, dll.T


def solve_ba_banded(poses0, points0, bw: BandedWork, *, fixed_mask=None,
                    max_iters=30, loss=None, costs=None):
    """LM bundle adjustment on the slot-major banded layout, the same
    iteration trajectory as the JAX package's ``solve_ba_banded``, with an
    exact linear solve every step.

    poses0: SE3 with R (C, 3, 3), t (C, 3); points0 (L, 3) in the original
    landmark order, as are the returned state's points; fixed_mask (C,) bool
    (default: camera 0). The loop runs on the host with one sync a step; if
    `costs` is a list, the cost at the start and after each step is appended
    to it. On the card the block-tridiagonal kernel takes super-blocks of
    m = 6 max(K, 2) <= 512, every band K <= 32 that `build_banded_work`
    accepts by default. Returns a BAState."""
    if loss is not None:
        raise NotImplementedError("robust loss= is not ported yet")
    set_full_precision()
    if fixed_mask is None:
        fixed_mask = torch.zeros(bw.n_cams, dtype=torch.bool,
                                 device=points0.device)
        fixed_mask[0] = True
    final = lm_loop(
        poses0, points0[bw.gather_idx],
        lambda poses, points: _banded_quantities(poses, points, bw),
        lambda blocks, lam: _solve_banded(*blocks, lam, fixed_mask, bw),
        max_iters=max_iters, costs=costs)
    real = bw.scatter_idx < bw.n_points
    points = points0.clone()
    points[bw.scatter_idx[real]] = final.points[real]
    return final._replace(points=points)
