"""Incremental trajectory smoothing on the banded layout, the online
smoother (port of ``slam_tricks_tpu/solvers/incremental.py``).

1. The full-horizon ``BandedWork`` is built once; cameras arrive by
   turning their slots' weights on (``active_weight``). The kernel's camera
   index is built from the weights it sums, so each arrival builds one
   (``active_work``) and reuses it for its Gauss-Newton steps and their
   backtracking costs.
2. The reduced camera system's stored block-tridiagonal factor is
   extended, not recomputed: the block-Cholesky loop runs only over the
   tail super-blocks that the arrival can touch
   (``banded_flat.block_tridiag_factor_extend``).
3. Updates are restricted to the tail (cameras >= arrival head - K and the
   landmarks rooted there), so the prefix band blocks, and with them the
   stored prefix factor, stay exact.

On the card the linearize + assemble of every step and cost runs the
``ba_assemble`` kernel, and ``smoother_init``'s batch solve the
``tridiag_solve`` kernel; the stored factor and its substitutions are
plain torch.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import se3, so3
from slam_tricks_tpu_torch.ops.ba_assemble import layout_index
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.solvers.banded_flat import (
    BandedWork, TridiagFactor, _assemble_bands, _backsub, _banded_quantities,
    _cam_rhs, _group_superblocks, block_tridiag_factor,
    block_tridiag_factor_extend, scatter_slots, solve_ba_banded,
    tridiag_backward, tridiag_forward)
from slam_tricks_tpu_torch.solvers.common import first_camera_fixed


def slot_c0(bw: BandedWork):
    """(Lpad,) first camera of each slot column."""
    return torch.repeat_interleave(bw.c0, bw.chunk)


def active_weight(bw: BandedWork, n_active):
    """The weights with arrivals masked: slot (k, l) is live iff its camera
    c0[l] + k < n_active (not wrapped modulo C)."""
    K = bw.w.shape[0]
    cam = slot_c0(bw)[None, :] + torch.arange(K, device=bw.w.device)[:, None]
    return bw.w * (cam < n_active).to(bw.w.dtype)


def active_work(bw: BandedWork, n_active):
    """bw with the weights of the first n_active cameras, and on a CUDA
    device the camera index of those weights."""
    w = active_weight(bw, n_active)
    return bw._replace(w=w, cam_index=layout_index(w, bw.cam_of_slot,
                                                   bw.n_cams))


class IncrementalState(NamedTuple):
    poses: object            # SE3 (C,): estimates (tail) and anchors (prefix)
    points_s: torch.Tensor   # (Lpad, 3) landmark estimates, slot order
    fac: TridiagFactor       # the stored factor of the current system
    cost: torch.Tensor


def _gn_step(poses, points_s, bw_eff: BandedWork, *, lam, fixed_mask,
             fac_prev=None, c_changed=0, loss=None):
    """gn_step_stored on the arrival-masked layout bw_eff."""
    C = bw_eff.n_cams
    K = bw_eff.w.shape[0]
    (Hpp, gp, Hll, gl, W), cost = _banded_quantities(poses, points_s, bw_eff,
                                                     loss)
    bands, hinv, _, _, free = _assemble_bands(Hpp, Hll, W, lam, fixed_mask,
                                              bw_eff)
    b = -(gp - _cam_rhs(W, hinv, gl, bw_eff)) * free[:, None]
    Dm, Em, Kb = _group_superblocks(bands, C)
    if fac_prev is None:
        fac = block_tridiag_factor(Dm, Em)
    else:
        # changes at cameras >= c_changed touch landmarks rooted at
        # c0 >= c_changed - K + 1, whose band blocks lie at cameras
        # >= c_changed - K + 1: the super-blocks < g0 are unchanged
        fac = block_tridiag_factor_extend(fac_prev, Dm, Em,
                                          max(0, (int(c_changed) - K) // Kb))
    G, m = Dm.shape[0], Dm.shape[1]
    rm = b.new_zeros((G * Kb, 6))
    rm[:C] = b
    dp = tridiag_backward(fac, tridiag_forward(fac, rm.view(G, m)))
    dp = dp.reshape(G * Kb, 6)[:C]
    return dp, _backsub(dp, free, W, hinv, gl, bw_eff), fac, cost


def gn_step_stored(poses, points_s, bw: BandedWork, *, lam, fixed_mask,
                   n_active=None, fac_prev=None, c_changed=0, loss=None):
    """One damped Gauss-Newton step on the (arrival-masked, if n_active is
    given) banded problem, solved through the stored factor: fac_prev's
    prefix is reused and only the super-blocks that changes at cameras
    >= c_changed (a Python int) reach are factored again; fac_prev=None
    factors anew. Returns (dp (C, 6), dl (Lpad, 3), fac, cost)."""
    robust.check(loss)
    bw_eff = bw if n_active is None else active_work(bw, n_active)
    return _gn_step(poses, points_s, bw_eff, lam=lam, fixed_mask=fixed_mask,
                    fac_prev=fac_prev, c_changed=c_changed, loss=loss)


def _apply_tail(poses, points_s, dp, dl, bw, c_update, n_active):
    """Retract the step on the tail only: cameras in [c_update, n_active)
    and landmarks rooted at c0 >= c_update; the prefix keeps its anchors,
    so the stored prefix factor stays exact."""
    C = poses.t.shape[0]
    c = torch.arange(C, device=dp.device)
    dp_m = dp * ((c >= c_update) & (c < n_active)).to(dp.dtype)[:, None]
    poses_new = se3.SE3(so3.retract(poses.R, dp_m[:, :3]),
                        poses.t + dp_m[:, 3:])
    lm_live = (slot_c0(bw) >= c_update).to(dl.dtype)
    return poses_new, points_s + dl * lm_live[:, None]


def _masked_cost(poses, points_s, bw_eff, loss=None):
    return _banded_quantities(poses, points_s, bw_eff, loss)[1]


def smoother_init(poses0, points0, bw: BandedWork, *, lam=1e-4,
                  fixed_mask=None, n_active=None, lm_iters=20, loss=None):
    """Start the smoother: an LM solve of the first n_active cameras'
    subproblem (``solve_ba_banded``, lambda_init=lam), then one stored
    factorization at its linearization. Returns (state, c_dirty): c_dirty
    is the lowest camera whose linearization changed after the stored
    factor (C: nothing moved)."""
    robust.check(loss)
    C = bw.n_cams
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(bw.n_cams, points0.device)
    bw_eff = bw if n_active is None else active_work(bw, n_active)
    out = solve_ba_banded(poses0, points0, bw_eff, fixed_mask=fixed_mask,
                          max_iters=lm_iters, lambda_init=lam, loss=loss)
    points_s = out.points[bw.gather_idx]
    _, _, fac, cost = _gn_step(out.poses, points_s, bw_eff, lam=lam,
                               fixed_mask=fixed_mask, loss=loss)
    return IncrementalState(poses=out.poses, points_s=points_s, fac=fac,
                            cost=cost), C


def smoother_arrive(state: IncrementalState, bw: BandedWork, *, a_prev,
                    a_new, c_dirty, lam=1e-4, fixed_mask=None, gn_steps=2,
                    loss=None):
    """Advance the stream from a_prev to a_new active cameras: gn_steps
    tail-restricted Gauss-Newton steps, each extending the stored factor
    over the tail super-blocks, and each step's length backtracked over
    1, 1/2, 1/4, 1/8 to the lowest cost. a_prev, a_new and c_dirty (what
    the previous smoother_init or smoother_arrive returned) are Python
    ints. Returns (state, c_dirty_new)."""
    robust.check(loss)
    K = bw.w.shape[0]
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(bw.n_cams,
                                        state.points_s.device)
    poses, points_s, fac = state.poses, state.points_s, state.fac
    # changes since the stored factor: states moved at >= c_dirty plus
    # observations newly live at cameras >= a_prev - K + 1
    c_update = max(0, a_prev - K)
    c_changed = min(int(c_dirty), c_update)
    bw_eff = active_work(bw, a_new)        # one camera index an arrival
    cost = state.cost
    for _ in range(max(gn_steps, 1)):
        dp, dl, fac, cost = _gn_step(
            poses, points_s, bw_eff, lam=lam, fixed_mask=fixed_mask,
            fac_prev=fac, c_changed=c_changed, loss=loss)
        # the applied step is the tail restriction of the Newton step, not
        # always a descent at full length: scaling it keeps lam, and so the
        # prefix band blocks, untouched
        best_cost, best_alpha = cost, torch.zeros((), dtype=dp.dtype,
                                                  device=dp.device)
        for alpha in (1.0, 0.5, 0.25, 0.125):
            p_try, s_try = _apply_tail(poses, points_s, alpha * dp,
                                       alpha * dl, bw, c_update, a_new)
            c_try = _masked_cost(p_try, s_try, bw_eff, loss)
            better = c_try < best_cost
            best_cost = torch.where(better, c_try, best_cost)
            best_alpha = torch.where(better, torch.full_like(best_alpha, alpha),
                                     best_alpha)
        poses, points_s = _apply_tail(poses, points_s, best_alpha * dp,
                                      best_alpha * dl, bw, c_update, a_new)
        cost = best_cost
        c_changed = c_update     # later steps: only the tail moved
    return IncrementalState(poses=poses, points_s=points_s, fac=fac,
                            cost=cost), c_update


def scatter_points(points_s, bw: BandedWork, n_points):
    """Slot-order landmark estimates back to the original order (L, 3);
    a landmark in no slot gets zeros."""
    return scatter_slots(points_s.new_zeros((n_points, 3)), points_s,
                         bw.scatter_idx)
