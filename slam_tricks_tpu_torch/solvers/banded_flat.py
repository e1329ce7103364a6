"""Slot-major banded-direct BA, the large-C trajectory solve (port of
``slam_tricks_tpu/solvers/banded_flat.py``): the solve, the stored
block-tridiagonal factor and the banded covariances.

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
2. the band blocks S[c + o, c] by chunk sums, added at the chunk's camera
   in an order fixed when the layout is built (``BandedWork.cam_table``,
   so the card returns the same bits on every run), damping and gauge, the
   super-block grouping;
3. the block-tridiagonal solve and the landmark back-substitution;
4. retract, accept or reject: ``schur.lm_loop``.

The math is the JAX package's, robust ``loss=`` included. Where the JAX
code multiplies by the (chunks, C) one-hot and rolls rows so that the TPU
never gathers, the port keeps each chunk's c0 as an integer and gathers and
adds at c0 + k.

The stored factor (``TridiagFactor``: ``block_tridiag_factor``, its
extension and the two substitutions) is what the loop-closure and the
incremental solvers build on; it is plain torch (the JAX package computes
it outside any Pallas kernel too): a sequential block-Cholesky loop over
the G super-blocks, and substitutions as affine prefix scans of batched
matrix products, as in the JAX package. ``block_tridiag_solve`` is the
JAX package's name of the block-tridiagonal solve (one or many right-hand
sides), which the VI chain solver calls. The covariances (``banded_covariances``) are the
Takahashi recursion on the super-blocks, plain torch.
"""

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_tricks_tpu_torch.ops.ba_assemble import (CameraIndex, assemble_out,
                                                   layout_index,
                                                   linearize_assemble)
from slam_tricks_tpu_torch.ops.tridiag_solve import tridiag_solve
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.solvers.common import (associative_scan,
                                                  device_constant,
                                                  device_index,
                                                  first_camera_fixed, psum,
                                                  set_full_precision,
                                                  sum_table, table_sum)
from slam_tricks_tpu_torch.solvers.schur import (SchurSteps, lm_graphed,
                                                 lm_loop)
from slam_tricks_tpu_torch.solvers.schur_flat_sm import (_DIAG6, _inv3x3_flat,
                                                         _sym6_expand,
                                                         damp_hll)
from slam_tricks_tpu_torch.utils.timer import annotate

_SYM33 = [0, 1, 2, 1, 3, 4, 2, 4, 5]     # (3, 3) entries of 6 upper-triangle


class BandedWork(NamedTuple):
    """Host-built slot-major layout of a trajectory problem, on the
    observations' device."""
    uv0: torch.Tensor          # (K, Lpad) measured u
    uv1: torch.Tensor          # (K, Lpad) measured v
    w: torch.Tensor            # (K, Lpad) weights, 0 = no observation
    cam_of_slot: torch.Tensor  # (K, Lpad) int32, (c0 + k) mod C
    cam_index: Optional[CameraIndex]  # the kernel's sums; None on the CPU
    cam_table: torch.Tensor    # (C, T) the (k, chunk) sums of each camera,
    #                            ``chunk_table``
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
    C, L = int(n_cams), int(n_points)
    with annotate("slam:layout.banded_work"):
        with annotate("slam:layout.track_table"):
            host = _banded_arrays(obs, C, L, dtype, chunk, max_band)
        with annotate("slam:layout.upload"):
            uv0, uv1, w_t, cam_t, c0_t, scatter_idx, gather_idx = (
                torch.as_tensor(np.ascontiguousarray(a), device=device)
                for a in host)
        with annotate("slam:layout.tables"):
            cam_index = layout_index(w_t, cam_t, C)
            cam_table = chunk_table(c0_t, w_t.shape[0], C)
    return BandedWork(
        uv0=uv0, uv1=uv1, w=w_t, cam_of_slot=cam_t, cam_index=cam_index,
        cam_table=cam_table, c0=c0_t, scatter_idx=scatter_idx,
        gather_idx=gather_idx, n_cams=C, n_points=L)


def _banded_arrays(obs, C, L, dtype, chunk, max_band):
    """`build_banded_work`'s layout in numpy: (uv0, uv1, w, cam_of_slot,
    each chunk's first camera, scatter_idx, gather_idx)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cam = obs.cam_idx.cpu().numpy().astype(np.int64)
    lm = obs.lm_idx.cpu().numpy().astype(np.int64)
    uv = obs.uv.cpu().numpy()
    w = obs.weight.cpu().numpy()
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
    return (uvg[:, 0], uvg[:, 1], wg, cam_of_slot.astype(np.int32), chunk_c0,
            scatter_idx, np.minimum(scatter_idx, L - 1))


def chunk_table(c0, K, C):
    """``common.sum_table`` of the (K, chunks) chunk sums into their camera
    (c0 + k) mod C: (C, T), T at most K times the chunks of one c0."""
    k = torch.arange(K, device=c0.device)[:, None]
    return sum_table(((c0[None, :] + k) % C).reshape(-1), C)


def _banded_quantities(poses, points_s, bw: BandedWork, loss=None,
                       psum_axis=None):
    """Linearize + assemble on the slot grid: (Hpp (C, 21), gp (C, 6),
    Hll (6, Lpad), gl (3, Lpad), W (18, K, Lpad)), cost. psum_axis: a
    process group whose ranks each hold a slice of the chunks
    (``parallel/banded_dist``): Hpp, gp and the cost are summed over the
    ranks in one ``all_reduce``, the landmark side stays the rank's own."""
    C = bw.n_cams
    Hpp, gp, Hll, gl, W, cost = linearize_assemble(
        poses.R.reshape(C, 9), poses.t, points_s, bw.uv0, bw.uv1, bw.w,
        bw.cam_of_slot, bw.cam_index, loss)
    Hpp, gp, cost = psum((Hpp, gp, cost), psum_axis)
    return (Hpp, gp, Hll, gl, W), cost


def _cam_sum(cols, bw: BandedWork):
    """Per-camera sums of slot columns: cols (n, k, Lpad), k <= K, slot
    rows 0..k-1 -> (C, n). Sums each chunk first, then the chunks of a
    camera in the fixed order of bw.cam_table."""
    n, k, Lpad = cols.shape
    chunks = bw.c0.shape[0]
    part = cols.reshape(n, k, chunks, Lpad // chunks).sum(-1)
    K = bw.w.shape[0]
    if k < K:
        part = torch.cat([part, part.new_zeros((n, K - k, chunks))], dim=1)
    return table_sum(part.reshape(n, K * chunks), bw.cam_table)


def _mat3vec(h, v):
    """Symmetric 3x3 blocks (6, Lpad) times vectors (3, Lpad) -> (3, Lpad)."""
    H = h[device_index(_SYM33, h.device)].view(3, 3, -1)
    return H[:, 0] * v[0] + H[:, 1] * v[1] + H[:, 2] * v[2]


def _cam_rhs(W, hinv, gl, bw: BandedWork):
    """y = sum over slots of W Hll^-1 gl at the slot's camera -> (C, 6);
    the reduced right-hand side is -(gp - y)."""
    W3 = W.view(6, 3, W.shape[1], -1)
    u = _mat3vec(hinv, gl)
    y = W3[:, 0] * u[0, None] + W3[:, 1] * u[1, None] + W3[:, 2] * u[2, None]
    return _cam_sum(y, bw)


def _backsub(dp, free, W, hinv, gl, bw: BandedWork):
    """Landmark steps dl = Hll^-1 (-gl - sum_k W(k)^T dp[c0 + k]), the fixed
    cameras' steps taken as 0 -> (Lpad, 3)."""
    K = W.shape[1]
    dpn = (dp * free[:, None]).T[:, bw.cam_of_slot.long()]      # (6, K, Lpad)
    t = (W.view(6, 3, K, -1) * dpn[:, None]).sum(dim=(0, 2))    # (3, Lpad)
    return _mat3vec(hinv, -gl - t).T


def _assemble_bands(Hpp, Hll, W, lam, fixed_mask, bw: BandedWork,
                    psum_axis=None):
    """Damped, gauge-fixed band blocks S[c + o, c] of the reduced camera
    system, bands (K, C, 6, 6), and the landmark inverse hinv (6, Lpad), the
    Marquardt diagonals dpp (C, 6), dll (3, Lpad) and free (C,). psum_axis:
    the K band downdates are the rank's part, summed over the group's ranks
    in one ``all_reduce`` of (K, C, 36) before the damped Hpp is added."""
    dtype, device = Hpp.dtype, Hpp.device
    C = bw.n_cams
    K = W.shape[1]

    dpp = torch.clamp_min(Hpp[:, device_index(_DIAG6, device)], 1e-12)
    Hpp_d = _sym6_expand(Hpp) + torch.diag_embed(lam * dpp)
    Hll_d, dll = damp_hll(Hll, lam)
    hinv = torch.stack(_inv3x3_flat(Hll_d))

    # Y(k) = W(k) Hll^-1, (6, 3, K, Lpad)
    W3 = W.view(6, 3, K, -1)
    H = hinv[device_index(_SYM33, device)].view(3, 3, -1)
    Y = (W3[:, 0, None] * H[0][None, :, None] + W3[:, 1, None] * H[1][None, :, None]
         + W3[:, 2, None] * H[2][None, :, None])
    # band o: -sum over slots k of Y(k + o) W(k)^T, at camera c0 + k
    bands = []
    for o in range(K):
        prod = (Y[:, 0, None, o:] * W3[None, :, 0, :K - o]
                + Y[:, 1, None, o:] * W3[None, :, 1, :K - o]
                + Y[:, 2, None, o:] * W3[None, :, 2, :K - o])   # (6, 6, K-o, Lpad)
        bands.append(-_cam_sum(prod.reshape(36, K - o, -1), bw))
    bands = psum((torch.stack(bands),), psum_axis)[0].view(K, C, 6, 6)
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
    G Kb by identity diagonal blocks. Returns (Dm, Em, Kb). Two gathers
    from the bands and the numbers 0 and 1 by ``_superblock_index``'s
    tables, which are made once a (K, C) and device."""
    K = bands.shape[0]
    iD, iE, Kb = _superblock_index(K, C, bands.device)
    src = torch.cat([bands.reshape(-1),
                     device_constant((0.0, 1.0), bands.dtype, bands.device)])
    return src[iD], src[iE], Kb


@functools.lru_cache(maxsize=16)
def _superblock_index(K, C, device):
    """(iD (G, m, m), iE (G-1, m, m), Kb): where each entry of Dm and Em
    comes from in ``_group_superblocks``' source, the K C 36 band entries
    (band o at camera c, entry (i, j), at (o C + c) 36 + 6 i + j), then 0,
    then 1. Diagonal super-block g holds at (a, b), cameras g Kb + a and
    g Kb + b, band a - b at camera g Kb + b (a >= b) or its transpose, band
    b - a at g Kb + a (a < b); sub-diagonal block g holds band
    a - b + Kb at camera g Kb + b (a < b; zero else), the band rows past a
    super-block's end. Band o >= K, and every band at a padding camera
    c >= C but the identity of band 0, is zero."""
    Kb = max(K, 2)
    G = -(-C // Kb)
    zero, one = K * C * 36, K * C * 36 + 1
    i = np.arange(6)
    ii, jj = i[:, None], i[None, :]

    def blocks(o, c, transpose):
        """(..., 6, 6) source indices of band o at camera c (arrays)."""
        o, c = o[..., None, None], c[..., None, None]
        t = transpose[..., None, None]
        band = (o * C + c) * 36 + np.where(t, 6 * jj + ii, 6 * ii + jj)
        eye = np.where((o == 0) & (c >= C) & (ii == jj), one, zero)
        return np.where((o < K) & (c < C), band, eye)

    g, a, b = np.meshgrid(np.arange(G), np.arange(Kb), np.arange(Kb),
                          indexing="ij")
    lower = a >= b
    iD = blocks(np.abs(a - b), g * Kb + np.minimum(a, b), ~lower)
    iE = np.where(lower[..., None, None], zero,
                  blocks(a - b + Kb, g * Kb + b, np.zeros_like(lower)))[:-1]
    m = 6 * Kb

    def table(x):
        return torch.as_tensor(np.ascontiguousarray(
            x.transpose(0, 1, 3, 2, 4).reshape(-1, m, m)), device=device)
    return table(iD), table(iE), Kb


def reduced_camera_system(Hpp, gp, Hll, gl, W, lam, fixed_mask,
                          bw: BandedWork, psum_axis=None, replay=None):
    """The damped, gauge-fixed reduced camera system as a super-block
    tridiagonal: (Dm (G, m, m), Em (G-1, m, m), rm (G, m), hinv (6, Lpad),
    dpp (C, 6), dll (3, Lpad), free (C,)); the last four are what the
    back-substitution and the LM step need. psum_axis: the bands and the
    right-hand side's landmark part are summed over the group's ranks, so
    that every rank holds the same system. replay: a CUDA graph captured
    from a call with these same tensors (``schur.lm_graphed``), replayed in
    place of the computation; its outputs are returned."""
    if replay is not None:
        return replay()
    C = bw.n_cams
    bands, hinv, dpp, dll, free = _assemble_bands(Hpp, Hll, W, lam,
                                                  fixed_mask, bw, psum_axis)
    # rhs: b = -(gp - W Hll^-1 gl), zero on the padding cameras
    y = psum((_cam_rhs(W, hinv, gl, bw),), psum_axis)[0]
    b = -(gp - y) * free[:, None]
    Dm, Em, Kb = _group_superblocks(bands, C)
    rm = torch.zeros((Dm.shape[0] * Kb, 6), dtype=b.dtype, device=b.device)
    rm[:C] = b
    return Dm, Em, rm.view(Dm.shape[:2]), hinv, dpp, dll, free


def block_tridiag_solve(D, E, r):
    """Solve the SPD block-tridiagonal system D (G, m, m), E (G-1, m, m)
    (E[g] = T[g+1, g]) for r (G, m) or (G, m, q): ``ops.tridiag_solve``,
    block cyclic reduction (the CUDA kernel on the card, its plain version
    on the CPU). The JAX package's ``method`` ("cr", "scan", "pallas") only
    picks its implementation of this same solve."""
    return tridiag_solve(D.contiguous(), E.contiguous(), r.contiguous())


def _solve_banded(Hpp, gp, Hll, gl, W, lam, fixed_mask, bw: BandedWork,
                  psum_axis=None):
    """Damped, gauge-fixed exact solve of the reduced camera system by the
    super-block tridiagonal solve, then the landmark back-substitution.
    Returns (dp (C, 6), dl (Lpad, 3), diag_pp (C, 6), diag_ll (Lpad, 3)).
    With psum_axis the solve is replicated: every rank solves the same
    summed system."""
    C = bw.n_cams
    with annotate("slam:rcs"):
        Dm, Em, rm, hinv, dpp, dll, free = reduced_camera_system(
            Hpp, gp, Hll, gl, W, lam, fixed_mask, bw, psum_axis)
    with annotate("slam:linear_solve"):
        dp = tridiag_solve(Dm, Em, rm).reshape(-1, 6)[:C]
    with annotate("slam:backsub"):
        dl = _backsub(dp, free, W, hinv, gl, bw)
    return dp, dl, dpp, dll.T


def _steps(bw: BandedWork, fixed_mask, loss):
    """The pieces of an LM step that ``schur.lm_graphed`` runs apart."""
    C = bw.n_cams
    tables = _superblock_index(bw.w.shape[0], C, bw.w.device)

    def linearize(poses, points, out):
        *blocks, cost = linearize_assemble(
            poses.R.reshape(C, 9), poses.t, points, bw.uv0, bw.uv1, bw.w,
            bw.cam_of_slot, bw.cam_index, loss, out=out)
        return tuple(blocks), cost

    def system(blocks, lam, replay=None):
        return reduced_camera_system(*blocks, lam, fixed_mask, bw,
                                     replay=replay)

    def linear_solve(system, out):
        return tridiag_solve(*system[:3], out=out).view(-1, 6)[:C]

    return SchurSteps(
        linearize=linearize,
        linearize_out=lambda: assemble_out(C, bw.w, bw.cam_index),
        system=system, linear_solve=linear_solve,
        solve_out=lambda: bw.w.new_empty(tables[0].shape[:2]),  # (G, m)
        back_substitute=lambda dp, blocks, system: _backsub(
            dp, system[6], blocks[4], system[3], blocks[3], bw),
        diagonals=lambda system: (system[4], system[5].T),
        keep=tables)


def solve_ba_banded(poses0, points0, bw: BandedWork, *, fixed_mask=None,
                    max_iters=30, lambda_init=1e-4, xtol=1e-12, loss=None,
                    costs=None, psum_axis=None, slot_points=False):
    """LM bundle adjustment on the slot-major banded layout, the same
    iteration trajectory as the JAX package's ``solve_ba_banded``, with an
    exact linear solve every step.

    poses0: SE3 with R (C, 3, 3), t (C, 3); points0 (L, 3) in the original
    landmark order, as are the returned state's points; fixed_mask (C,) bool
    (default: camera 0); lambda_init the first damping; the solve stops
    when an accepted step is shorter than xtol; loss a
    ``residuals.robust.Loss`` or None. The loop runs on the host with one
    sync a step; on a CUDA device with no psum_axis each iteration replays
    CUDA graphs of the plain-torch work between the kernels
    (``schur.lm_graphed``, captured on a layout's first solve of more than
    one iteration), with the same bits; the graphs keep `bw` and
    `fixed_mask` alive until another layout's graphed solve or
    ``schur.release_graphs()``. If `costs` is a list, the cost at the start
    and after each step is appended to it. On the card the
    block-tridiagonal kernel takes super-blocks of m = 6 max(K, 2) <= 512,
    every band K <= 32 that `build_banded_work` accepts by default. Returns
    a BAState.

    psum_axis: a ``torch.distributed`` process group whose ranks each run
    this solve on their own slice of the chunks (``parallel/banded_dist``:
    `bw` is the rank's slice); the camera-side sums and the LM's scalars are
    summed over the ranks, the super-block solve is replicated, and the
    landmarks stay the rank's own. None: one process, no collective.
    slot_points=True returns the points in the slice's slot order
    (Lpad, 3), not scattered to the landmark order (the distributed wrapper
    gathers them once)."""
    robust.check(loss)
    set_full_precision()
    if points0.is_cuda and psum_axis is None:
        final = lm_graphed(
            poses0, points0[bw.gather_idx], (bw, fixed_mask),
            ("banded", loss, xtol),
            lambda: _steps(bw, first_camera_fixed(bw.n_cams, points0.device)
                           if fixed_mask is None else fixed_mask, loss),
            max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
            costs=costs)
    else:
        if fixed_mask is None:
            fixed_mask = first_camera_fixed(bw.n_cams, points0.device)
        final = lm_loop(
            poses0, points0[bw.gather_idx],
            lambda poses, points: _banded_quantities(poses, points, bw, loss,
                                                     psum_axis),
            lambda blocks, lam: _solve_banded(*blocks, lam, fixed_mask, bw,
                                              psum_axis),
            max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
            costs=costs, psum_axis=psum_axis)
    if slot_points:
        return final
    return final._replace(points=scatter_slots(points0, final.points,
                                               bw.scatter_idx))


def scatter_slots(points, slot_points, scatter_idx):
    """A copy of points (L, ...) with the real slots' rows of slot_points
    (scatter_idx < L) written at their landmark."""
    real = scatter_idx < points.shape[0]
    out = points.clone()
    out[scatter_idx[real]] = slot_points[real]
    return out


# ---- the stored block-tridiagonal factor ----

class TridiagFactor(NamedTuple):
    """Stored block-Cholesky factor T = Lt Ltᵀ of an SPD block-tridiagonal
    matrix T (Lt block lower-bidiagonal). Unlike cyclic reduction, which
    keeps no factor, it gives repeated substitutions with bounded entries:
    the loop-closure solve needs Lt^-1 U so that its capacitance is the
    Gram matrix I - UtᵀUt, and the incremental smoother reuses its
    prefix."""
    L: torch.Tensor      # (G, m, m) lower-triangular diagonal blocks
    F: torch.Tensor      # (G-1, m, m) sub-diagonal blocks, F[g] at (g+1, g)


def _chol(A):
    """Lower Cholesky factor, NaN where A is not positive definite (as the
    JAX package's, so that the solver's bad-step branch sees it)."""
    Lc, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, Lc)


def _factor_tail(Lp, D, E):
    """Block-Cholesky steps after the block whose factor is Lp, over the
    diagonal blocks D (n, m, m) and the couplings E (n, m, m) into them:
    F = E Lp^-T, L = chol(D - F Fᵀ), three launches a block. A block that
    is not positive definite makes its L and every later L and F NaN, as
    the JAX package's scan does. Returns (L (n, m, m), F (n, m, m))."""
    m = D.shape[-1]
    if D.shape[0] == 0:
        return D.new_zeros((0, m, m)), D.new_zeros((0, m, m))
    Ls, Fs, infos = [], [], []
    for Dg, Eg in zip(D, E):
        F = torch.linalg.solve_triangular(Lp, Eg.mT, upper=False).mT
        Lp, info = torch.linalg.cholesky_ex(torch.addmm(Dg, F, F.mT,
                                                        alpha=-1))
        Ls.append(Lp)
        Fs.append(F)
        infos.append(info)
    # the first failure spoils its block's L, and F and L of every later one
    bad = torch.cummax((torch.stack(infos) != 0).int(), 0).values.bool()
    bad_f = torch.cat([bad.new_zeros(1), bad[:-1]])
    nan = torch.tensor(torch.nan, dtype=D.dtype, device=D.device)
    return (torch.where(bad[:, None, None], nan, torch.stack(Ls)),
            torch.where(bad_f[:, None, None], nan, torch.stack(Fs)))


def block_tridiag_factor(D, E):
    """Factor the SPD block-tridiagonal (D (G, m, m), E (G-1, m, m) its
    sub-diagonal) by the sequential block-Cholesky loop."""
    L0 = _chol(D[0])
    Ls, Fs = _factor_tail(L0, D[1:], E)
    return TridiagFactor(L=torch.cat([L0[None], Ls]), F=Fs)


def block_tridiag_factor_extend(fac: TridiagFactor, D, E, g0):
    """The factor of (D, E) from `fac`, the factor of a matrix whose blocks
    [:g0] and couplings E[:g0-1] are the same: the prefix is reused and
    the loop runs over the super-blocks [g0:] only. g0 a Python int; g0 <= 0
    factors anew, g0 >= G reuses fac's first G blocks."""
    G = D.shape[0]
    g0 = int(g0)
    if g0 <= 0:
        return block_tridiag_factor(D, E)
    if g0 >= G:
        return TridiagFactor(L=fac.L[:G], F=fac.F[:max(G - 1, 0)])
    Ls, Fs = _factor_tail(fac.L[g0 - 1], D[g0:], E[g0 - 1:])
    return TridiagFactor(L=torch.cat([fac.L[:g0], Ls]),
                         F=torch.cat([fac.F[:g0 - 1], Fs]))


def _affine_scan(A, b):
    """The inclusive prefix of y_g = A_g y_{g-1} + b_g, b (G, m, q), as
    pairs (A_g ... A_0, y_g), by ``common.associative_scan``: ~2 log2(G)
    rounds of batched matrix products, its sums in the JAX package's
    order."""
    return associative_scan(
        lambda e1, e2: (e2[0] @ e1[0], torch.baddbmm(e2[1], e2[0], e1[1])),
        (A, b))


def tridiag_forward(fac: TridiagFactor, R):
    """Lt^-1 R, R (G, m) or (G, m, q): y_g = L_g^-1 (R_g - F_{g-1} y_{g-1})
    as the affine prefix y_g = A_g y_{g-1} + c_g with A_0 = 0,
    A_g = -L_g^-1 F_{g-1}, c = L^-1 R: batched triangular solves and
    ``_affine_scan``."""
    Rm = R if R.dim() == 3 else R[..., None]
    c = torch.linalg.solve_triangular(fac.L, Rm, upper=False)
    A = torch.cat([torch.zeros_like(fac.L[:1]),
                   -torch.linalg.solve_triangular(fac.L[1:], fac.F,
                                                  upper=False)])
    y = _affine_scan(A, c)[1]
    return y if R.dim() == 3 else y[..., 0]


def tridiag_backward(fac: TridiagFactor, Y):
    """Lt^-T Y, Y (G, m) or (G, m, q): x_g = L_g^-T (Y_g - F_gᵀ x_{g+1}) as
    the affine prefix of the reversed blocks, B_g = -L_g^-T F_gᵀ."""
    Ym = Y if Y.dim() == 3 else Y[..., None]
    Lt = fac.L.mT
    d = torch.linalg.solve_triangular(Lt, Ym, upper=True)
    B = -torch.linalg.solve_triangular(Lt[:-1], fac.F.mT, upper=True)
    A = torch.cat([torch.zeros_like(fac.L[:1]), B.flip(0)])
    x = _affine_scan(A, d.flip(0))[1].flip(0)
    return x if Y.dim() == 3 else x[..., 0]


# ---- covariances ----

def _batched_spd_inverse(A):
    """(B, m, m) SPD inverses by Cholesky: A^-1 = Xᵀ X, X = L^-1."""
    Lc = _chol(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    X = torch.linalg.solve_triangular(Lc, eye, upper=False)
    return X.mT @ X


def _takahashi_inverse_blocks(Dm, Em, G):
    """The diagonal blocks P_g = (S^-1)_{g,g} and the sub-diagonal blocks
    Bsub_g = (S^-1)_{g+1,g} of the block-tridiagonal inverse, by the
    two-sweep Takahashi recursion:
    M_g = (D_g - E_{g-1} M_{g-1} E_{g-1}ᵀ)^-1, P_{G-1} = M_{G-1},
    P_g = M_g + M_g E_gᵀ P_{g+1} E_g M_g, Bsub_g = -P_{g+1} E_g M_g."""
    inv = _batched_spd_inverse
    if G == 1:
        return inv(Dm), None
    M = [inv(Dm[:1])[0]]
    for g in range(1, G):
        T = Em[g - 1] @ M[-1]
        M.append(inv((Dm[g] - T @ Em[g - 1].T)[None])[0])
    P = [None] * G
    P[G - 1] = M[G - 1]
    for g in range(G - 2, -1, -1):
        T = Em[g].T @ P[g + 1]
        P[g] = M[g] + M[g] @ (T @ Em[g]) @ M[g]
    P, M = torch.stack(P), torch.stack(M)
    return P, -(P[1:] @ Em @ M[:-1])


def _sinv_bands(P, Bsub, C, K, Kb):
    """(S^-1)[c + o, c] camera blocks, offsets o = 0 .. K-1, from the
    super-block inverse blocks: a list of (C, 6, 6), rows c >= C - o
    zero."""
    G = P.shape[0]
    dtype, device = P.dtype, P.device
    Pr = P.reshape(G, Kb, 6, Kb, 6)
    Br = Bsub.reshape(G - 1, Kb, 6, Kb, 6) if Bsub is not None else None
    out = []
    for o in range(K):
        rows = []
        for r in range(Kb):
            if r + o < Kb:
                blk = Pr[:, r + o, :, r, :]
            elif Br is not None:
                blk = torch.cat([Br[:, r + o - Kb, :, r, :],
                                 P.new_zeros((1, 6, 6))])
            else:
                blk = P.new_zeros((G, 6, 6))
            rows.append(blk)
        band = torch.stack(rows, dim=1).reshape(G * Kb, 6, 6)[:C]
        mask = (torch.arange(C, device=device) < C - o).to(dtype)
        out.append(band * mask[:, None, None])
    return out


def banded_pose_covariances(poses, points, bw: BandedWork, fixed_mask, *,
                            lam=0.0, loss=None):
    """Marginal 6x6 pose covariances (C, 6, 6) at the solution of a
    trajectory problem: the diagonal blocks of S^-1 by the Takahashi
    recursion on the super-block tridiagonal. Fixed cameras get zero.
    `points` in the original landmark order."""
    cov, _ = banded_covariances(poses, points, bw, fixed_mask, lam=lam,
                                loss=loss, compute_landmarks=False)
    return cov


def banded_covariances(poses, points, bw: BandedWork, fixed_mask, *,
                       lam=0.0, loss=None, compute_landmarks=False):
    """(pose_cov (C, 6, 6), point_cov (L, 3, 3) or None) at the solution.
    A landmark's marginal is Hll^-1 + Hll^-1 W_lᵀ Sinv_l W_l Hll^-1, Sinv_l
    the blocks of S^-1 over its track's cameras (at most K consecutive
    ones, so within the diagonal and sub-diagonal super-blocks)."""
    robust.check(loss)
    C, L = bw.n_cams, points.shape[0]
    dtype, device = points.dtype, points.device
    (Hpp, _, Hll, _, W), _ = _banded_quantities(poses, points[bw.gather_idx],
                                                bw, loss)
    K, Lpad = W.shape[1], W.shape[2]
    bands, hinv, _, _, free = _assemble_bands(
        Hpp, Hll, W, torch.tensor(lam, dtype=dtype, device=device),
        fixed_mask, bw)
    Dm, Em, Kb = _group_superblocks(bands, C)
    G = Dm.shape[0]
    Cp = G * Kb
    P, Bsub = _takahashi_inverse_blocks(Dm, Em, G)
    Pr = P.reshape(G, Kb, 6, Kb, 6)
    r = torch.arange(Kb, device=device)
    pose_cov = Pr[:, r, :, r, :].transpose(0, 1).reshape(Cp, 6, 6)[:C]
    pose_cov = pose_cov * free[:, None, None]
    if not compute_landmarks:
        return pose_cov, None

    # landmarks, slot-major: V(k) = W(k) Hll^-1, zero at fixed cameras
    # (their rows of S^-1 are the gauge's identity blocks)
    sb = _sinv_bands(P, Bsub, Cp, K, Kb)
    chunk = bw.chunk
    free_p = torch.cat([free, free.new_zeros(Cp - C)])
    H = hinv[device_index(_SYM33, hinv.device)].view(3, 3, Lpad)
    V = torch.einsum("imkl,mjl->kijl", W.view(6, 3, K, Lpad), H)
    cam0 = bw.c0[None, :] + torch.arange(K, device=device)[:, None]
    fk = free_p[cam0.clamp(0, Cp - 1)].repeat_interleave(chunk, dim=1)
    V = V * fk[:, None, None, :]
    A = torch.zeros((3, 3, Lpad), dtype=dtype, device=device)
    for k in range(K):
        for k2 in range(K):
            o = k - k2
            cam = (bw.c0 + min(k, k2)).clamp(0, Cp - 1)
            Q = sb[abs(o)][cam]          # (S^-1)[c0 + k, c0 + k2], chunk rows
            if o < 0:
                Q = Q.mT
            Q = Q.repeat_interleave(chunk, dim=0)                   # (Lpad, 6, 6)
            A = A + torch.einsum("ijl,lim,mnl->jnl", V[k], Q, V[k2])
    cov_l = (H + A).permute(2, 0, 1)
    cov_l = cov_l * (bw.w.sum(dim=0) > 0).to(dtype)[:, None, None]
    return pose_cov, scatter_slots(cov_l.new_zeros((L, 3, 3)), cov_l,
                                   bw.scatter_idx)
