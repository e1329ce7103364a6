"""Flat-layout Schur-complement BA (port of
``slam_tricks_tpu/solvers/schur_flat.py``): the same damping, gauge and
control law as ``schur.solve_ba(linear_solver="dense")``, over blocks laid
out for the device.

In the JAX package this module keeps per-observation quantities as flat
(N, k) columns, reduces them by one-hot products and track-table gathers,
and reaches the TPU's fused linearize + assemble kernel through
``pallas_meta``. The port lays the observations on the (K, L) slot grid of
their track table (slot k of landmark l, ``schur_flat_sm.SlotWork``), where
every track gather is a reshape, so one iteration is

1. linearize + assemble by ``ops.ba_assemble`` (the CUDA kernel on the
   card, its plain version on the CPU), W kept on the grid;
2. the reduced camera system of ``schur_flat_sm.reduced_camera_system``,
   with an optional Gaussian prior on the first cameras (``prior=``, the
   sliding-window marginalization prior), solved by ``ops.spd_solve``; or
   with ``linear="pcg"`` the block-tridiagonal PCG of ``solvers/pcg_flat``;
3. the shared ``schur.lm_loop``.

The JAX package's ``pallas_meta``, ``pallas_interpret`` and
``chol_backend`` only pick its implementation of the same math; the port
has no counterpart (on the card it always runs its kernels). With
``psum_axis`` (a ``torch.distributed`` process group) and ``linear="pcg"``
it is the rank's part of the distributed large-C solve of
``parallel/pcg_dist``.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.ops.spd_solve import spd_solve
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
from slam_tricks_tpu_torch.solvers.common import (first_camera_fixed,
                                                  set_full_precision)
from slam_tricks_tpu_torch.solvers.schur import build_track_table, lm_loop
from slam_tricks_tpu_torch.solvers.schur_flat_sm import (
    SlotWork, _quantities_sm, back_substitute, reduced_camera_system,
    slot_work_from_table, with_b_table)


class FlatWork(NamedTuple):
    """Static per-problem structure of the flat solver, on the
    observations' device: the slot grid of the observations' track table
    and the slot of each observation."""
    slot: SlotWork
    obs_slot: torch.Tensor   # (N,) int64 slot id k L + l, -1 where the
    #                          observation has weight 0 (no slot)


def obs_slots(table):
    """(N_table,) slot ids k L + l of the observations a track table
    (numpy) names, by observation: -1 for one it leaves out."""
    idx = np.asarray(table.obs_idx)
    msk = np.asarray(table.mask) > 0
    L, K = idx.shape
    ll, kk = np.nonzero(msk)
    n_obs = int(idx[msk].max()) + 1 if msk.any() else 0
    out = np.full(n_obs, -1, np.int64)
    out[idx[ll, kk]] = kk.astype(np.int64) * L + ll
    return out


def flat_work_from_table(obs, table, n_cams, dtype=torch.float32,
                         use_cam_table=None):
    """The FlatWork of observations laid out by their track table."""
    if use_cam_table is None:
        use_cam_table = n_cams > 128
    slots = obs_slots(table)
    obs_slot = np.full(obs.uv.shape[0], -1, np.int64)
    obs_slot[:slots.shape[0]] = slots
    return FlatWork(
        slot=slot_work_from_table(obs, table, n_cams, dtype,
                                  with_b_table=not use_cam_table),
        obs_slot=torch.as_tensor(obs_slot, device=obs.uv.device))


def build_flat_work(obs, n_cams, n_points, dtype=torch.float32,
                    use_cam_table=None, grid=False):
    """Host side: the track table and slot grid of `obs` (BAObservations of
    tensors). use_cam_table: where the JAX package swaps its (N, C)
    one-hot for a camera table (None: C > 128), the port leaves out the
    (L C)-row summation table of the dense B, whose size is of the same
    order; a dense ``solve_ba_flat`` then builds it once, before its loop. grid=True
    requires observations in ``grid_order_obs`` order (row l K + k is slot
    k of landmark l) and raises ValueError otherwise."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    table = build_track_table(obs.cam_idx.cpu().numpy(),
                              obs.lm_idx.cpu().numpy(),
                              obs.weight.cpu().numpy(), n_points=n_points,
                              dtype=np_dtype)
    if grid:
        K = table.obs_idx.shape[1]
        expect = np.arange(n_points * K, dtype=np.int64).reshape(n_points, K)
        tmask = table.mask > 0
        if not np.array_equal(table.obs_idx[tmask], expect[tmask]):
            raise ValueError("grid=True requires grid_order_obs layout")
    return flat_work_from_table(obs, table, n_cams, dtype, use_cam_table)


def grid_order_obs(obs, n_points, dtype=torch.float32):
    """Host side: the observations reordered into track-grid order, row
    l K + k the k-th observation of landmark l; unused slots are weight-0
    padding at camera 0 with lm_idx l. On the observations' device."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cam_np = obs.cam_idx.cpu().numpy()
    w_np = obs.weight.cpu().numpy()
    table = build_track_table(cam_np, obs.lm_idx.cpu().numpy(), w_np,
                              n_points=n_points, dtype=np_dtype)
    L, K = table.obs_idx.shape
    flat = table.obs_idx.reshape(-1)
    mflat = table.mask.reshape(-1) > 0
    cam = np.where(mflat, cam_np[flat], 0).astype(np.int32)
    lm = np.repeat(np.arange(L, dtype=np.int32), K)
    uv = obs.uv.cpu().numpy()[flat].astype(np_dtype)
    w = np.where(mflat, w_np[flat], 0.0).astype(np_dtype)
    t = lambda a: torch.as_tensor(a, device=obs.uv.device)  # noqa: E731
    return BAObservations(cam_idx=t(cam), lm_idx=t(lm), uv=t(uv),
                          weight=t(w))


def _check_obs(obs, work: FlatWork):
    if obs.uv.shape[0] != work.obs_slot.shape[0]:
        raise ValueError(f"{obs.uv.shape[0]} observations, but the work was "
                         f"built from {work.obs_slot.shape[0]}")


def _iteration_quantities(poses, points, work: FlatWork, loss=None):
    """Linearize + assemble on the slot grid (``ops.ba_assemble``): (Hpp
    (C, 21), gp (C, 6), Hll (6, L), gl (3, L), W (18, K, L), cost)."""
    (Hpp, gp, Hll, gl, W), cost = _quantities_sm(poses, points, work.slot,
                                                  loss)
    return Hpp, gp, Hll, gl, W, cost


def _solve_flat(Hpp, gp, Hll, gl, W, lam, fixed_mask, work: FlatWork,
                prior=None):
    """Damped Schur solve from the grid's blocks. Returns (dp (C, 6),
    dl (L, 3), diag_pp (C, 6), diag_ll (L, 3)).

    prior: None or (H (P, P), g (P,)), a Gaussian prior on the tangent of
    the first P // 6 cameras (``sliding_window``): H is added to the head
    of the gauge-fixed reduced camera system and -g to its rhs; the
    cameras it covers must be free."""
    C = work.slot.n_cams
    S, b, Hll_inv, dpp, dll = reduced_camera_system(Hpp, gp, Hll, gl, W, lam,
                                                    fixed_mask, work.slot)
    if prior is not None:
        Hp, g = prior
        P = Hp.shape[0]
        S[:P, :P] += Hp
        b[:P] += -g
    dp = spd_solve(S, b).reshape(C, 6)
    return dp, back_substitute(dp, W, Hll_inv, gl, work.slot), dpp, dll.T


def solve_ba_flat(poses0, points0, obs, work: FlatWork, *, fixed_mask=None,
                  max_iters=30, lambda_init=1e-4, xtol=1e-12, linear="dense",
                  pcg_work=None, cg_iters=100, cg_tol=1e-6, loss=None,
                  psum_axis=None, costs=None):
    """LM bundle adjustment, flat layout; the iteration of the JAX
    package's ``solve_ba_flat`` and of ``schur.solve_ba`` (dense). `work`
    from ``build_flat_work(obs, C, L)``.

    linear: "dense" forms and factors the reduced camera system
    (``ops.spd_solve``); "pcg" runs the block-tridiagonal PCG of
    ``pcg_flat`` with pcg_work=pcg_flat.build_pcg_work(obs, C), cg_iters
    and cg_tol. loss: a ``residuals.robust.Loss`` or None. `costs` as in
    ``schur.lm_loop``. Returns a BAState.

    psum_axis: a ``torch.distributed`` process group whose ranks each run
    this solve on their own landmarks (``parallel/pcg_dist``: `obs`,
    `work`, `pcg_work` and `points0` are the rank's), poses replicated; the
    camera-side sums and the LM's scalars are summed over the ranks. It
    requires linear="pcg" (the dense solve would sum a (3L, 6C) matrix over
    the ranks) and raises ValueError otherwise. None: one process."""
    if linear not in ("dense", "pcg"):
        raise ValueError(f"unknown linear {linear!r}")
    if psum_axis is not None and linear != "pcg":
        raise ValueError("psum_axis requires linear='pcg'")
    if linear == "pcg" and pcg_work is None:
        raise ValueError("linear='pcg' requires pcg_work="
                         "pcg_flat.build_pcg_work(obs, C)")
    robust.check(loss)
    _check_obs(obs, work)
    set_full_precision()
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(work.slot.n_cams, points0.device)
    if linear == "pcg":
        from slam_tricks_tpu_torch.solvers.pcg_flat import solve_rcs_pcg_flat
        pcg_work.check(work)
    else:
        work = work._replace(slot=with_b_table(work.slot))

    def solve(blocks, lam):
        if linear == "pcg":
            return solve_rcs_pcg_flat(*blocks, lam, fixed_mask, work,
                                      pcg_work, cg_iters=cg_iters,
                                      cg_tol=cg_tol, psum_axis=psum_axis)
        return _solve_flat(*blocks, lam, fixed_mask, work)

    return lm_loop(
        poses0, points0,
        lambda poses, points: _quantities_sm(poses, points, work.slot, loss,
                                             psum_axis),
        solve, max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
        costs=costs, psum_axis=psum_axis)
