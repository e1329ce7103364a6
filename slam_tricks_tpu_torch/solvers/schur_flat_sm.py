"""Slot-major flat Schur BA, the headline solve (port of
``slam_tricks_tpu/solvers/schur_flat_sm.py``).

Levenberg-Marquardt bundle adjustment with the landmarks eliminated by the
Schur complement. Every per-observation quantity lives on the (K, L) slot
grid: slot k of landmark l, padding slots with weight 0. One iteration:

1. linearize + assemble (``ops/ba_assemble``, a CUDA kernel on the card);
2. damp, whiten each slot by the landmark's 3x3 Cholesky factor, build the
   whitened B (3L, 6C) by a sum in a fixed order (``common.table_sum``) and
   form S = Hpp + lam D - BᵀB with one full-float32 matrix product;
3. solve the reduced camera system (``ops/spd_solve``, a CUDA kernel on the
   card) and back-substitute the landmark steps;
4. retract on SO(3) x R^3 (tangent [omega, dt]) and accept or reject with
   the Nielsen control law.

The math is the JAX package's, robust ``loss=`` included. Its TPU layout is
not: where the JAX code multiplies by bf16 one-hot matrices so that the TPU
never gathers, the port gathers, and sums over slots in an order fixed when
the layout is built (``SlotWork.b_table``, ``cam_table``), so that the card
returns the same bits on every run; ``index_add_`` would sum by float
atomics there. The one-hot products are exact, so the results are the
same.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_tricks_tpu_torch.ops.ba_assemble import (_IJ3, _IJ6, CameraIndex,
                                                   assemble_out, layout_index,
                                                   linearize_assemble)
from slam_tricks_tpu_torch.ops.spd_solve import spd_solve
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.solvers.common import (device_constant,
                                                  device_index,
                                                  first_camera_fixed, psum,
                                                  set_full_precision,
                                                  sum_table, table_sum)
from slam_tricks_tpu_torch.solvers.schur import (SchurSteps,
                                                 build_track_table,
                                                 lm_graphed, lm_loop)
from slam_tricks_tpu_torch.utils.timer import annotate

# index lists, indexed through ``common.device_index`` (their tensors on
# the device, made once)
_DIAG6 = [k for k, (i, j) in enumerate(_IJ6) if i == j]    # [0, 6, 11, 15, 18, 20]
_DIAG3 = [k for k, (i, j) in enumerate(_IJ3) if i == j]    # [0, 3, 5]
_SYM6 = [_IJ6.index((min(i, j), max(i, j))) for i in range(6) for j in range(6)]
_EYE3 = [1.0, 0.0, 0.0, 1.0, 0.0, 1.0]   # the identity, upper triangle


class SlotWork(NamedTuple):
    """Static per-problem structure, slot-major, on the solver's device."""
    uv0: torch.Tensor           # (K, L) measured u
    uv1: torch.Tensor           # (K, L) measured v
    w: torch.Tensor             # (K, L) weights (0 = padding slot)
    mask: torch.Tensor          # (K, L) 1/0
    cam_of_slot: torch.Tensor   # (K, L) int32, camera 0 on padding slots
    cam_index: Optional[CameraIndex]  # the kernel's sums; None on the CPU
    b_table: Optional[torch.Tensor]  # (L C, T) the slots of each
    #                             (landmark, camera) block of B:
    #                             ``slot_tables``; None: left out
    #                             (``with_b_table`` adds it)
    cam_table: torch.Tensor     # (C, T) the slots of each camera
    n_cams: int

    @property
    def n_points(self):
        return self.mask.shape[1]


def slot_tables(cam_of_slot, mask, n_cams, with_b_table=True):
    """(b_table, cam_table): the ``common.sum_table`` orders of the live
    slots n = k L + l (mask > 0) into row l C + cam of B and into their
    camera (b_table None unless with_b_table). b_table has one column
    unless a landmark has two live slots of one camera; padding slots add
    exact zeros, so they are left out."""
    K, L = mask.shape
    cam = cam_of_slot.long().reshape(-1)
    live = mask.reshape(-1) > 0
    none = torch.full_like(cam, -1)
    b_table = None
    if with_b_table:
        lm = torch.arange(L, device=cam.device).repeat(K)
        b_table = sum_table(torch.where(live, lm * n_cams + cam, none),
                            L * n_cams)
    return b_table, sum_table(torch.where(live, cam, none), n_cams)


def with_b_table(work: SlotWork):
    """`work` with B's (L C)-row table, built here if it was left out: once
    a problem, before a dense solve's loop."""
    if work.b_table is not None:
        return work
    return work._replace(b_table=slot_tables(work.cam_of_slot, work.mask,
                                             work.n_cams)[0])


def build_slot_work(obs, n_cams, n_points, dtype=torch.float32,
                    use_onehot=None):
    """Host side: the slot-major grid of arbitrary observations, on the
    observations' device. The slots of landmark l are its observations in
    input order; padding slots carry weight 0 and camera 0.

    use_onehot is accepted for calls written against the JAX package, where
    it picks between a bf16 camera one-hot and a camera gather table; the
    port never builds a one-hot, so every C takes the gather route (the JAX
    package's use_onehot=False)."""
    del use_onehot
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with annotate("slam:layout.slot_work"):
        with annotate("slam:layout.track_table"):
            table = build_track_table(
                obs.cam_idx.cpu().numpy(), obs.lm_idx.cpu().numpy(),
                obs.weight.cpu().numpy().astype(np.float64),
                n_points=n_points, dtype=np_dtype)
        return slot_work_from_table(obs, table, n_cams, dtype)


def slot_work_from_table(obs, table, n_cams, dtype=torch.float32,
                         with_b_table=True):
    """The SlotWork of observations laid out by their track table
    (``schur.build_track_table``, numpy): slot k of landmark l holds
    observation table.obs_idx[l, k] where table.mask is 1. with_b_table
    False leaves out B's (L C)-row table, which only a dense solve needs
    (``with_b_table``)."""
    device = obs.uv.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with annotate("slam:layout.track_table"):
        cam_np = obs.cam_idx.cpu().numpy()
        w_np = obs.weight.cpu().numpy().astype(np.float64)
        uv_np = obs.uv.cpu().numpy()
        idx = np.asarray(table.obs_idx)      # (L, K)
        msk = np.asarray(table.mask) > 0
        L, K = idx.shape

        def slotm(a):
            out = np.zeros((L, K) + a.shape[1:], a.dtype)
            out[msk] = a[idx[msk]]
            return np.ascontiguousarray(np.moveaxis(out, 1, 0))  # (K, L, ...)

        host = (slotm(uv_np.astype(np_dtype)), slotm(w_np.astype(np_dtype)),
                slotm(cam_np.astype(np.int32)),
                np.ascontiguousarray(msk.T.astype(np_dtype)))
    with annotate("slam:layout.upload"):
        uv_sm, w_sm, cam_sm, mask = (torch.as_tensor(a, device=device)
                                     for a in host)
    with annotate("slam:layout.tables"):
        b_table, cam_table = slot_tables(cam_sm, mask, n_cams, with_b_table)
        cam_index = layout_index(w_sm, cam_sm, n_cams)
    return SlotWork(
        uv0=uv_sm[..., 0].contiguous(), uv1=uv_sm[..., 1].contiguous(),
        w=w_sm, mask=mask, cam_of_slot=cam_sm, cam_index=cam_index,
        b_table=b_table, cam_table=cam_table, n_cams=int(n_cams))


def _quantities_sm(poses, points, work: SlotWork, loss=None, psum_axis=None):
    """Linearize + assemble: (Hpp (C, 21), gp (C, 6), Hll (6, L), gl (3, L),
    W (18, K, L)), cost. psum_axis: a process group whose ranks each hold
    their own landmarks' slots (``parallel/pcg_dist``): the camera side
    (Hpp, gp, cost) is summed over the ranks, the landmark side stays the
    rank's own; None: one process."""
    C = work.n_cams
    Hpp, gp, Hll, gl, W, cost = linearize_assemble(
        poses.R.reshape(C, 9), poses.t, points, work.uv0, work.uv1, work.w,
        work.cam_of_slot, work.cam_index, loss)
    Hpp, gp, cost = psum((Hpp, gp, cost), psum_axis)
    return (Hpp, gp, Hll, gl, W), cost


def _sym6_expand(flat):
    """(..., 21) upper-triangle columns -> (..., 6, 6) symmetric."""
    return flat[..., device_index(_SYM6, flat.device)].reshape(
        flat.shape[:-1] + (6, 6))


def _inv3x3_flat(h):
    """Inverse of symmetric 3x3 blocks given as 6 upper-triangle arrays."""
    a, b, c, d, e, f = h
    A = d * f - e * e
    B = c * e - b * f
    Cc = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * Cc
    idet = 1.0 / det
    return [A * idet, B * idet, Cc * idet, D * idet, E * idet, F * idet]


def damp_hll(Hll, lam):
    """The landmark blocks' damping, Hll (6, L) -> (damped (6, L), clamped
    diagonal (3, L)): + lam times the clamped diagonal; an empty landmark
    (no live slot) gets the identity, since its eps-damped zero block has
    det ~ (lam 1e-12)^3, which underflows f32 to an inf inverse."""
    diag = device_index(_DIAG3, Hll.device)
    dll = torch.clamp_min(Hll[diag], 1e-12)
    empty = (Hll[0] + Hll[3] + Hll[5]) <= 0.0
    damp = torch.zeros_like(Hll)
    damp[diag] = lam * dll
    eye3 = device_constant(_EYE3, Hll.dtype, Hll.device)[:, None]
    return torch.where(empty, eye3, Hll + damp), dll


def _chol3_flat(h):
    """Lower Cholesky factor [l00, l10, l11, l20, l21, l22] of 3x3 blocks."""
    a, b, c, d, e, f = h
    l00 = torch.sqrt(a)
    inv00 = 1.0 / l00
    l10 = b * inv00
    l20 = c * inv00
    l11 = torch.sqrt(d - l10 * l10)
    inv11 = 1.0 / l11
    l21 = (e - l20 * l10) * inv11
    l22 = torch.sqrt(f - l20 * l20 - l21 * l21)
    return [l00, l10, l11, l20, l21, l22]


def reduced_camera_system(Hpp, gp, Hll, gl, W, lam, fixed_mask,
                          work: SlotWork, replay=None):
    """The damped, gauge-fixed reduced camera system S dp = b from
    slot-major blocks. Returns (S (6C, 6C), b (6C,), Hll_inv (6 x (L,)),
    dpp (C, 6), dll (3, L)): the last three are the landmark inverse and the
    Marquardt diagonals that the back-substitution and the LM step need.
    replay: a CUDA graph captured from a call with these same tensors
    (``schur.lm_graphed``), replayed in place of the computation; its
    outputs are returned."""
    if replay is not None:
        return replay()
    dtype, device = gp.dtype, gp.device
    C, L = work.n_cams, work.n_points
    K = work.mask.shape[0]

    dpp = torch.clamp_min(Hpp[:, device_index(_DIAG6, device)],
                          1e-12)                                  # (C, 6)
    Hpp_d = _sym6_expand(Hpp) + torch.diag_embed(lam * dpp)
    Hll_d, dll = damp_hll(Hll, lam)
    Hll_inv = _inv3x3_flat(Hll_d)

    # whiten per slot: X = Ld^-1 Wᵀ, (18, K, L) with row r*6 + i = X[r, i]
    l00, l10, l11, l20, l21, l22 = _chol3_flat(Hll_d)
    i00, i11, i22 = 1.0 / l00, 1.0 / l11, 1.0 / l22
    m = work.mask
    Wm = W * m
    x0 = Wm[0::3] * i00
    x1 = (Wm[1::3] - l10 * x0) * i11
    x2 = (Wm[2::3] - l20 * x0 - l21 * x1) * i22
    X = torch.cat([x0, x1, x2], dim=0)

    # B[(l, r), (c, i)] = sum of X[r*6 + i, k, l] over the slots k of l with
    # camera c; S = Hpp_d - BᵀB
    if work.b_table is None:
        raise ValueError("the slot work was built without B's table: pass "
                         "schur_flat_sm.with_b_table(work)")
    Bl = table_sum(X.reshape(18, K * L), work.b_table)           # (L C, 18)
    B = Bl.view(L, C, 3, 6).permute(0, 2, 1, 3).reshape(3 * L, 6 * C)
    S = (-(B.T @ B)).view(C, 6, C, 6)
    ci = torch.arange(C, device=device)
    S[ci, :, ci, :] += Hpp_d

    # rhs: b = -(gp - W Hll^-1 gl), reduced per camera
    a_, b_, c_, d_, e_, f_ = Hll_inv
    u0 = a_ * gl[0] + b_ * gl[1] + c_ * gl[2]
    u1 = b_ * gl[0] + d_ * gl[1] + e_ * gl[2]
    u2 = c_ * gl[0] + e_ * gl[1] + f_ * gl[2]
    W3 = W.view(6, 3, K, L)
    y = W3[:, 0] * (u0 * m) + W3[:, 1] * (u1 * m) + W3[:, 2] * (u2 * m)
    b = -(gp - table_sum(y.reshape(6, K * L), work.cam_table))

    # gauge: identity rows and columns for the fixed cameras
    free = (~fixed_mask).to(dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[ci, :, ci, :] += (fixed_mask.to(dtype)[:, None, None]
                        * torch.eye(6, dtype=dtype, device=device))
    b = b * free[:, None]
    return S.reshape(6 * C, 6 * C), b.reshape(6 * C), Hll_inv, dpp, dll


def back_substitute(dp, W, Hll_inv, gl, work: SlotWork):
    """The landmark steps dl = Hll^-1 (-gl - Wᵀ dp) (L, 3), dp gathered per
    slot and summed over each landmark's slots."""
    K, L = work.mask.shape
    a_, b_, c_, d_, e_, f_ = Hll_inv
    m = work.mask
    W3 = W.view(6, 3, K, L)
    dpn = dp.T[:, work.cam_of_slot.long()]                        # (6, K, L)
    acc = W3[0] * dpn[0] * m
    for i in range(1, 6):
        acc = acc + W3[i] * dpn[i] * m
    t_ = acc.sum(dim=1)                                           # (3, L)
    rhs = [-gl[j] - t_[j] for j in range(3)]
    dl0 = a_ * rhs[0] + b_ * rhs[1] + c_ * rhs[2]
    dl1 = b_ * rhs[0] + d_ * rhs[1] + e_ * rhs[2]
    dl2 = c_ * rhs[0] + e_ * rhs[1] + f_ * rhs[2]
    return torch.stack([dl0, dl1, dl2], dim=1)


def _solve_sm(Hpp, gp, Hll, gl, W, lam, fixed_mask, work: SlotWork):
    """Damped Schur solve from slot-major blocks. Returns (dp (C, 6),
    dl (L, 3), diag_pp (C, 6), diag_ll (L, 3))."""
    with annotate("slam:rcs"):
        S, b, Hll_inv, dpp, dll = reduced_camera_system(Hpp, gp, Hll, gl, W,
                                                        lam, fixed_mask, work)
    with annotate("slam:linear_solve"):
        dp = spd_solve(S, b).reshape(work.n_cams, 6)
    with annotate("slam:backsub"):
        dl = back_substitute(dp, W, Hll_inv, gl, work)
    return dp, dl, dpp, dll.T


def _steps(work: SlotWork, fixed_mask, loss):
    """The pieces of an LM step that ``schur.lm_graphed`` runs apart."""
    C = work.n_cams

    def linearize(poses, points, out):
        *blocks, cost = linearize_assemble(
            poses.R.reshape(C, 9), poses.t, points, work.uv0, work.uv1,
            work.w, work.cam_of_slot, work.cam_index, loss, out=out)
        return tuple(blocks), cost

    def system(blocks, lam, replay=None):
        return reduced_camera_system(*blocks, lam, fixed_mask, work,
                                     replay=replay)

    def linear_solve(system, out):
        return spd_solve(system[0], system[1], out=out).view(C, 6)

    return SchurSteps(
        linearize=linearize,
        linearize_out=lambda: assemble_out(C, work.w, work.cam_index),
        system=system, linear_solve=linear_solve,
        solve_out=lambda: work.w.new_empty(6 * C),
        back_substitute=lambda dp, blocks, system: back_substitute(
            dp, blocks[4], system[2], blocks[3], work),
        diagonals=lambda system: (system[3], system[4].T))


def solve_ba_flat_sm(poses0, points0, work: SlotWork, *, fixed_mask=None,
                     max_iters=30, lambda_init=1e-4, xtol=1e-12, loss=None,
                     costs=None):
    """LM bundle adjustment, slot-major flat layout; the same iteration
    trajectory as the JAX package's ``solve_ba_flat_sm``.

    poses0: SE3 with R (C, 3, 3), t (C, 3); points0 (L, 3); fixed_mask (C,)
    bool (default: camera 0); lambda_init the first damping; the solve
    stops when an accepted step is shorter than xtol; loss a
    ``residuals.robust.Loss`` or None. The loop runs on the host over
    device tensors and reads the stop flag once per iteration; on a CUDA
    device each iteration replays CUDA graphs of the plain-torch work
    between the kernels (``schur.lm_graphed``, captured on a layout's first
    solve of more than one iteration), with the same bits; the graphs keep
    `work` and `fixed_mask` alive until another layout's graphed solve or
    ``schur.release_graphs()``. If `costs` is a list, the cost at the start
    and after each iteration is appended to it (device scalars). Returns a
    BAState."""
    robust.check(loss)
    set_full_precision()
    if points0.is_cuda:
        return lm_graphed(
            poses0, points0, (work, fixed_mask), ("flat_sm", loss, xtol),
            lambda: _steps(work, first_camera_fixed(work.n_cams,
                                                    points0.device)
                           if fixed_mask is None else fixed_mask, loss),
            max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
            costs=costs)
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(work.n_cams, points0.device)
    return lm_loop(
        poses0, points0,
        lambda poses, points: _quantities_sm(poses, points, work, loss),
        lambda blocks, lam: _solve_sm(*blocks, lam, fixed_mask, work),
        max_iters=max_iters, lambda_init=lambda_init, xtol=xtol, costs=costs)
