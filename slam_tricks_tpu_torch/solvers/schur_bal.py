"""Bundle adjustment of BAL problems on the flat Schur path: 9-parameter
cameras (``residuals/bal.py``: the pose, a focal length and two radial
distortion terms, in pixels), heavy-tailed tracks, and the reduced camera
system summed over within-track pairs.

The layout (``build_bal_work``, once a problem, on the host):

- **Buckets.** A photo collection's tracks run from 2 to hundreds of
  cameras, so one (K, L) slot grid would hold mostly padding. Each
  landmark goes to the bucket of its track length rounded up to a power
  of two, K = 1, 2, 4, ..., and each bucket is a slot-major grid of its
  own (``ops.ba_assemble.Grid``). The landmarks are renumbered bucket by
  bucket (``BalWork.perm``); ``solve_bal`` takes and returns them in the
  caller's order.
- **Pairs.** Every within-track pair of live slots (a, b), a == b
  included, enumerated bucket by bucket and laid out by
  ``schur.pair_tables``, the pair sum that ``schur.solve_ba``'s paired
  solver shares: oriented so that cam_a <= cam_b, sorted stably by its
  block (cam_a, cam_b) and cut into segments of one block. A segment's
  9 x 9 sum is one small matrix product; the segments of a block are then
  summed in a tree whose every level's order is fixed by a table.

One iteration: the 9-wide linearize + assemble kernel a bucket, the camera
sums added bucket after bucket (``linearize_assemble_grids``); the
reduced camera system in three stages (``rcs_stages``): damping, the
landmark blocks' Cholesky factors, each slot whitened, X = Ld^-1 Wᵀ, and
the right-hand side; M = sum over pairs of X_aᵀ X_b, PAIR_CHUNK pairs at a
time (span ``slam:rcs.pairs``), so that its memory is the slots' and a
chunk's, never a dense (3L, 9C) B; then S = Hpp_d - (M + Mᵀ), the gauge
(the fixed cameras' whole 9-blocks identity) and a Jacobi scaling of S,
as Ceres scales by default; ``spd_solve`` (the CUDA kernel on the card),
the landmark back-substitution and the retract, with the Nielsen control
law of ``schur.lm_loop``. On CUDA the loop runs as ``schur.lm_graphed``'s
CUDA graphs, the reduced system a graph a stage. Every sum runs in an
order fixed when the layout is built: the card gives the same bits on
every run.

The counters ``LIVE_PAIRS``, ``LIVE_SLOTS`` and ``ALLOCATED_SLOTS`` hold
the last layout built's within-track pairs (a <= b), live slots and
allocated slots.
"""

from contextlib import nullcontext
from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.ops.ba_assemble import (Grid, grids_out,
                                                   layout_index,
                                                   linearize_assemble_grids)
from slam_tricks_tpu_torch.ops.spd_solve import spd_solve
from slam_tricks_tpu_torch.residuals import bal, robust
from slam_tricks_tpu_torch.solvers.common import (device_index,
                                                  first_camera_fixed,
                                                  set_full_precision,
                                                  sum_table, table_sum)
from slam_tricks_tpu_torch.solvers.schur import (PAIR_CHUNK, PairTables,
                                                 SchurSteps, lm_graphed,
                                                 lm_loop, pair_mass,
                                                 pair_tables)
from slam_tricks_tpu_torch.solvers.schur_flat_sm import _chol3_flat, damp_hll
from slam_tricks_tpu_torch.utils.timer import annotate

P = 9                  # the camera block's width
_CANDIDATES = 2 ** 24  # slot pairs a bucket enumerates at once, building
ACC = torch.float64    # the reduced system's sums and landmark blocks

LIVE_PAIRS = 0         # the last layout's within-track pairs (a <= b)
LIVE_SLOTS = 0         # its live slots (observations)
ALLOCATED_SLOTS = 0    # its slots, padding included

_IJ9 = [(i, j) for i in range(P) for j in range(i, P)]
_DIAG9 = [k for k, (i, j) in enumerate(_IJ9) if i == j]
_SYM9 = [_IJ9.index((min(i, j), max(i, j))) for i in range(P)
         for j in range(P)]


class BalWork(NamedTuple):
    """Static per-problem structure, on the solver's device."""
    grids: tuple           # ``Grid`` a bucket, its landmarks from l0 on
    perm: torch.Tensor     # (L,) int64 the landmark at each row
    inv: torch.Tensor      # (L,) int64 the row of each landmark
    cam_table: torch.Tensor  # (C, T) the live slots of each camera
    pairs: PairTables      # the within-track pairs of the slots
    n_cams: int
    n_slots: int           # slots of all buckets; slot id N is a zero row

    @property
    def n_points(self):
        return self.perm.shape[0]


def _bucket_sizes(k):
    """Each track's bucket: its length rounded up to a power of two (1 for
    a landmark with one observation or none)."""
    K = np.ones_like(k)
    while (K < k).any():
        K = np.where(K < k, 2 * K, K)
    return K


def build_bal_work(obs, n_cams, n_points, dtype=torch.float32,
                   chunk=PAIR_CHUNK):
    """Host side: the bucketed slot layout of the observations (cam_idx,
    lm_idx, uv, weight) and its pair tables, on the observations' device.
    The slots of landmark l are its observations of weight > 0 in input
    order. chunk: pairs whose products are formed at once."""
    global LIVE_SLOTS, ALLOCATED_SLOTS
    device = obs.uv.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    C, L = int(n_cams), int(n_points)
    with annotate("slam:layout.buckets"):
        cam = obs.cam_idx.cpu().numpy().astype(np.int64)
        lm = obs.lm_idx.cpu().numpy().astype(np.int64)
        w = obs.weight.cpu().numpy().astype(np.float64)
        uv = obs.uv.cpu().numpy()
        live = np.flatnonzero(w > 0)
        k = np.bincount(lm[live], minlength=L)
        Kl = _bucket_sizes(k)
        perm = np.lexsort((np.arange(L), Kl))         # by bucket, stably
        inv = np.empty(L, np.int64)
        inv[perm] = np.arange(L)
        sizes, counts = np.unique(Kl, return_counts=True)
        l0s = np.cumsum(counts) - counts
        starts = np.cumsum(sizes * counts) - sizes * counts
        N = int((sizes * counts).sum())
        # each live observation's slot: its row's bucket, its rank in its
        # track (input order) and its column in the bucket
        row = inv[lm[live]]
        o = np.argsort(row, kind="stable")
        obs_sorted, row_sorted = live[o], row[o]
        first = np.searchsorted(row_sorted, np.arange(L))
        rank = np.arange(row_sorted.shape[0]) - first[row_sorted]
        bk = np.searchsorted(l0s, row_sorted, side="right") - 1
        slot = (starts[bk] + rank * counts[bk] + row_sorted - l0s[bk])
        flat = {"uv0": np.zeros(N, np_dtype), "uv1": np.zeros(N, np_dtype),
                "w": np.zeros(N, np_dtype), "cam": np.zeros(N, np.int32)}
        flat["uv0"][slot] = uv[obs_sorted, 0]
        flat["uv1"][slot] = uv[obs_sorted, 1]
        flat["w"][slot] = w[obs_sorted]
        flat["cam"][slot] = cam[obs_sorted]
        dev = {name: torch.as_tensor(a, device=device)
               for name, a in flat.items()}
        grids = []
        for K, Lb, l0, s0 in zip(sizes, counts, l0s, starts):
            K, Lb, s0 = int(K), int(Lb), int(s0)
            view = {name: a[s0:s0 + K * Lb].view(K, Lb)
                    for name, a in dev.items()}
            grids.append(Grid(view["uv0"], view["uv1"], view["w"],
                              view["cam"], layout_index(view["w"],
                                                        view["cam"], C),
                              int(l0)))
        cam_dest = torch.where(dev["w"] > 0, dev["cam"].long(), -1)
        cam_table = sum_table(cam_dest, C)
    LIVE_SLOTS, ALLOCATED_SLOTS = int(live.shape[0]), N
    with annotate("slam:layout.pairs"):
        pairs = layout_pairs(grids, starts, dev["cam"].long(), C, N, dtype,
                             chunk)
    return BalWork(grids=tuple(grids),
                   perm=torch.as_tensor(perm, device=device),
                   inv=torch.as_tensor(inv, device=device),
                   cam_table=cam_table, pairs=pairs, n_cams=C, n_slots=N)


def _bucket_pairs(live, s0):
    """One bucket's within-track pairs k1 <= k2 of live slots (live (K, L)
    bool, slot ids from s0), (a, b) a piece at a time, enumerated by
    (k1, k2) then landmark."""
    K, Lb = live.shape
    k1, k2 = torch.triu_indices(K, K, device=live.device)
    step = max(_CANDIDATES // Lb, 1)
    for p0 in range(0, k1.shape[0], step):
        q1, q2 = k1[p0:p0 + step], k2[p0:p0 + step]
        pi, li = torch.nonzero(live[q1] & live[q2], as_tuple=True)
        yield s0 + q1[pi] * Lb + li, s0 + q2[pi] * Lb + li


def layout_pairs(grids, starts, cam, C, N, dtype=torch.float32,
                 chunk=PAIR_CHUNK):
    """The ``schur.PairTables`` of the buckets' within-track pairs, over
    the slots (cam (N,) each slot's camera, starts each grid's first slot
    id), enumerated bucket by bucket."""
    global LIVE_PAIRS
    pairs = pair_tables((p for g, s0 in zip(grids, starts)
                         for p in _bucket_pairs(g.w > 0, int(s0))),
                        cam, C, N, dtype, chunk)
    LIVE_PAIRS = int((pairs.a < N).sum())
    return pairs


def _sym9_expand(flat):
    """(..., 45) upper-triangle columns -> (..., 9, 9) symmetric."""
    return flat[..., device_index(_SYM9, flat.device)].reshape(
        flat.shape[:-1] + (P, P))


def _hll_inverse(h):
    """The inverse of symmetric 3x3 blocks, 6 upper-triangle rows (6, L)
    -> (6, L)."""
    a, b, c, d, e, f = h
    A = d * f - e * e
    B = c * e - b * f
    Cc = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    idet = 1.0 / (a * A + b * B + c * Cc)
    return torch.stack([A, B, Cc, D, E, F]) * idet


def _prepare(Hpp, gp, Hll, gl, Ws, lam, work: BalWork):
    """The reduced system's first stage: (X (N + 1, 3, 9) the whitened
    slots Ld^-1 Wᵀ with a zero row last, in the dtype; Hll_inv (6, L),
    b (C, 9) the right-hand side before the gauge and Hpp_d (C, 9, 9), in
    ACC; dpp (C, 9), dll (3, L) in the dtype). The landmark blocks'
    inverses and factors are taken in ACC: a point seen from two close
    cameras has a block whose float32 inverse is off by its condition
    number's worth of ulps."""
    dtype, device = gp.dtype, gp.device
    dpp = torch.clamp_min(Hpp[:, device_index(_DIAG9, device)], 1e-12)
    Hpp_d = (_sym9_expand(Hpp).to(ACC)
             + torch.diag_embed(lam.to(ACC) * dpp.to(ACC)))
    Hll_d, dll = damp_hll(Hll.to(ACC), lam.to(ACC))
    Hll_inv = _hll_inverse(Hll_d)
    chol = _chol3_flat(Hll_d)
    u = _apply_sym3(Hll_inv, gl.to(ACC))                          # (3, L)
    xs, ys = [], []
    for g, W in zip(work.grids, Ws):
        K, Lb = g.w.shape
        lo, hi = g.l0, g.l0 + Lb
        l00, l10, l11, l20, l21, l22 = (c[lo:hi] for c in chol)
        W4 = W.to(ACC).view(P, 3, K, Lb)      # zero in a padding slot
        x0 = W4[:, 0] / l00
        x1 = (W4[:, 1] - l10 * x0) / l11
        x2 = (W4[:, 2] - l20 * x0 - l21 * x1) / l22
        xs.append(torch.stack([x0, x1, x2]).permute(2, 3, 0, 1).reshape(
            K * Lb, 3 * P).to(dtype))
        ub = u[:, lo:hi]
        ys.append((W4[:, 0] * ub[0] + W4[:, 1] * ub[1]
                   + W4[:, 2] * ub[2]).reshape(P, K * Lb))
    xs.append(Hpp.new_zeros((1, 3 * P)))                # slot N: the pads
    X = torch.cat(xs).view(-1, 3, P)
    b = -(gp.to(ACC) - table_sum(torch.cat(ys, dim=1), work.cam_table))
    return X, Hll_inv, b, Hpp_d, dpp, dll.to(dtype)


def _apply_sym3(h, v):
    """Symmetric 3x3 blocks (6 upper-triangle rows, (6, L)) times v
    (3, L)."""
    return torch.stack([h[0] * v[0] + h[1] * v[1] + h[2] * v[2],
                        h[1] * v[0] + h[3] * v[1] + h[4] * v[2],
                        h[2] * v[0] + h[4] * v[1] + h[5] * v[2]])


def _finish(prep, M, fixed_mask, work: BalWork):
    """The last stage: S = Hpp_d - (M + Mᵀ), the gauge, the Jacobi
    scaling: (S~ (9C, 9C), b~ (9C,), d (9C,), Hll_inv, dpp, dll, S~ and
    b~ in ACC) with S~ = D S D, b~ = D b, D = diag(d),
    d = diag(S)^-1/2; the step is D S~^-1 b~ (``scaled_solve``)."""
    _, Hll_inv, b, Hpp_d, dpp, dll = prep
    dtype, device = dll.dtype, b.device
    acc = b.dtype
    C = work.n_cams
    S = -(M + M.permute(1, 0, 3, 2)).permute(0, 2, 1, 3)    # (C, 9, C, 9)
    ci = torch.arange(C, device=device)
    S[ci, :, ci, :] += Hpp_d
    free = (~fixed_mask).to(acc)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[ci, :, ci, :] += (fixed_mask.to(acc)[:, None, None]
                        * torch.eye(P, dtype=acc, device=device))
    S = S.reshape(P * C, P * C)
    d = torch.rsqrt(torch.diagonal(S))
    S = S * d[:, None] * d[None, :]
    b = (b * free[:, None]).reshape(P * C) * d
    return (S.to(dtype), b.to(dtype), d.to(dtype), Hll_inv, dpp, dll, S, b)


# the reduced system's stages' spans, inside slam:rcs
_STAGE_SPANS = (None, "slam:rcs.pairs", None)


def rcs_stages(fixed_mask, work: BalWork):
    """The reduced camera system in stages, each stage(blocks, lam, done)
    -> a tuple of tensors: prepare, the pair sum, finish."""
    return (
        lambda blocks, lam, done: _prepare(*blocks[:4], blocks[4:], lam,
                                           work),
        lambda blocks, lam, done: (pair_mass(done[0][0], done[0][0],
                                             work.pairs, work.n_cams, ACC),),
        lambda blocks, lam, done: _finish(done[0], done[1][0], fixed_mask,
                                          work))


def reduced_camera_system(Hpp, gp, Hll, gl, Ws, lam, fixed_mask,
                          work: BalWork, replay=None):
    """The damped, gauge-fixed, Jacobi-scaled reduced camera system
    (``_finish``'s tuple) from the blocks of ``linearize_assemble_grids``
    (Ws: a bucket's W each). replay: the stages' CUDA graphs
    (``schur.lm_graphed``), replayed in place of the computation, each in
    its span."""
    done = ()
    stages = rcs_stages(fixed_mask, work)
    for i, (stage, span) in enumerate(zip(stages, _STAGE_SPANS)):
        with annotate(span) if span else nullcontext():
            done += (stage((Hpp, gp, Hll, gl, *Ws), lam, done)
                     if replay is None else replay[i](),)
    return done[-1]


def scaled_solve(system, out=None):
    """The step dp (9C,) of a ``reduced_camera_system``: ``spd_solve`` of
    the scaled system, one step of iterative refinement (the residual
    against S~ and b~ in ACC, solved again by ``spd_solve`` and added:
    rounding S~ to the dtype costs the step ~cond(S~) eps, ~1e-4 in float32
    at Dubrovnik's size, and the refinement takes that out), then scaled
    back; in place in out, where given."""
    S, b, d, S_acc, b_acc = system[:3] + system[6:8]
    x = spd_solve(S, b, out=out)
    r = (b_acc - S_acc @ x.to(S_acc.dtype)).to(x.dtype)
    return x.add_(spd_solve(S, r)).mul_(d)


def back_substitute(dp, Ws, Hll_inv, gl, work: BalWork):
    """The landmark steps dl = Hll^-1 (-gl - Wᵀ dp) (L, 3), each bucket's
    slots summed over k, in Hll_inv's dtype (ACC), rounded to dp's."""
    ts = []
    for g, W in zip(work.grids, Ws):
        W4 = W.view(P, 3, *g.w.shape)
        dpn = dp.T[:, g.cam_of_slot.long()]                       # (9, K, Lb)
        ts.append((W4 * dpn[:, None]).sum(dim=(0, 2)))            # (3, Lb)
    r = -(gl.to(Hll_inv.dtype) + torch.cat(ts, dim=1).to(Hll_inv.dtype))
    return _apply_sym3(Hll_inv, r).T.to(dp.dtype)


def _quantities(cams, points, work: BalWork, loss=None):
    Hpp, gp, Hll, gl, Ws, cost = linearize_assemble_grids(
        cams.R.reshape(work.n_cams, 9), cams.t, cams.intr, points,
        work.grids, loss)
    return (Hpp, gp, Hll, gl, *Ws), cost


def _solve(blocks, lam, fixed_mask, work: BalWork):
    """Damped Schur solve: (dp (C, 9), dl (L, 3), diag_pp (C, 9),
    diag_ll (L, 3))."""
    with annotate("slam:rcs"):
        system = reduced_camera_system(*blocks[:4], blocks[4:], lam,
                                       fixed_mask, work)
    with annotate("slam:linear_solve"):
        dp = scaled_solve(system).view(work.n_cams, P)
    with annotate("slam:backsub"):
        dl = back_substitute(dp, blocks[4:], system[3], blocks[3], work)
    return dp, dl, system[4], system[5].T


def _steps(work: BalWork, fixed_mask, loss):
    """The pieces of an LM step that ``schur.lm_graphed`` runs apart."""
    C, L = work.n_cams, work.n_points

    def linearize(cams, points, out):
        Hpp, gp, Hll, gl, Ws, cost = linearize_assemble_grids(
            cams.R.reshape(C, 9), cams.t, cams.intr, points, work.grids,
            loss, out=out)
        return (Hpp, gp, Hll, gl, *Ws), cost

    def system(blocks, lam, replay=None):
        return reduced_camera_system(*blocks[:4], blocks[4:], lam,
                                     fixed_mask, work, replay=replay)

    return SchurSteps(
        linearize=linearize,
        linearize_out=lambda: grids_out(C, L, work.grids),
        system=system,
        linear_solve=lambda system, out: scaled_solve(system, out).view(C, P),
        solve_out=lambda: work.grids[0].w.new_empty(P * C),
        back_substitute=lambda dp, blocks, system: back_substitute(
            dp, blocks[4:], system[3], blocks[3], work),
        diagonals=lambda system: (system[4], system[5].T),
        system_stages=rcs_stages(fixed_mask, work))


def solve_bal(poses0, intrinsics0, points0, work: BalWork, *,
              fixed_mask=None, max_iters=30, lambda_init=1e-4, xtol=1e-12,
              loss=None, costs=None):
    """LM bundle adjustment of BAL cameras on the bucketed flat layout.

    poses0: SE3 with R (C, 3, 3), t (C, 3) (world to camera, looking along
    +z: ``residuals/bal.py``); intrinsics0 (C, 3) [f, k1, k2];
    points0 (L, 3) in the caller's landmark order; fixed_mask (C,) bool
    (default: camera 0), whose cameras keep pose and intrinsics;
    lambda_init the first damping; the solve stops when an accepted step
    is shorter than xtol; loss a ``residuals.robust.Loss`` or None. On a
    CUDA device the iterations replay CUDA graphs (``schur.lm_graphed``,
    the reduced system a graph a stage), with the bits of the eager loop.
    If `costs` is a list, the cost at the start and after each iteration
    is appended to it (device scalars). Returns a BAState whose poses are
    ``residuals.bal.BALCameras`` and whose points are in the caller's
    order."""
    robust.check(loss)
    set_full_precision()
    cams0 = bal.BALCameras(poses0.R, poses0.t, intrinsics0)
    points = points0[work.perm]
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(work.n_cams, points0.device)
    if points0.is_cuda:
        out = lm_graphed(
            cams0, points, (work, fixed_mask), ("bal", loss, xtol),
            lambda: _steps(work, fixed_mask, loss), max_iters=max_iters,
            lambda_init=lambda_init, xtol=xtol, costs=costs)
    else:
        out = lm_loop(
            cams0, points,
            lambda cams, pts: _quantities(cams, pts, work, loss),
            lambda blocks, lam: _solve(blocks, lam, fixed_mask, work),
            max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
            costs=costs)
    return out._replace(points=out.points[work.inv])
