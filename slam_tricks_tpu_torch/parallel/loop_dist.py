"""Distributed loop-closure BA: the banded + Woodbury solver of
``solvers/loop_flat`` over a process group (port of
``slam_tricks_tpu/parallel/loop_dist.py``).

- The single-run (banded) landmark chunks are split over the ranks as in
  ``parallel/banded_dist``: each rank's landmark state, grids and slot
  algebra are its own; the band downdates, the single-run rhs, the
  linearization's camera sums and the LM scalars are summed over the
  ranks.
- The loop-closure structure is replicated: its M revisited landmarks
  and their |A| support cameras are few by construction, so every rank
  holds the whole loop-closure grid and computes the same loop-closure
  terms, added after the sums (no collective, no double count).

An LM iteration's traffic is therefore the banded solver's; the Woodbury
correction adds none.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.parallel.banded_dist import (rank_slice,
                                                        split_banded_work)
from slam_tricks_tpu_torch.parallel.multihost import (gather_owned,
                                                      global_obs_mesh,
                                                      make_global_array)
from slam_tricks_tpu_torch.solvers import loop_flat
from slam_tricks_tpu_torch.solvers.loop_flat import LoopWork, build_loop_work
from slam_tricks_tpu_torch.solvers.banded_flat import scatter_slots


class DistLoopWork(NamedTuple):
    banded_local: tuple       # each rank's BandedWork slice
    lc: LoopWork              # the whole LoopWork; its banded part unused
    n_points: int


def build_dist_loop_work(obs, n_cams, n_points, n_devices,
                         dtype=torch.float32, chunk=32, max_band=32):
    """The whole problem's loop-closure layout (``build_loop_work``), its
    banded chunk axis split over n_devices (``split_banded_work``), the
    loop-closure structure kept whole (replicated at run time)."""
    lw = build_loop_work(obs, n_cams, n_points, dtype=dtype, chunk=chunk,
                         max_band=max_band)
    return DistLoopWork(
        banded_local=split_banded_work(lw.banded, n_points, n_devices),
        lc=lw, n_points=int(n_points))


def make_ba_solver_loop_dist(group=None, *, max_iters=30, lambda_init=1e-4,
                             xtol=1e-12, loss=None):
    """Distributed loop-closure BA over the ranks of `group` (None: the
    world). Returns solve(poses0, points0, work: DistLoopWork, fixed_mask,
    costs=None) -> BAState with the global points, the same on every rank,
    called on every rank with the same arguments; the LM control and
    trajectory are the single-process loop solver's (up to the summation
    order across ranks). The rank's slice and the loop-closure grid are
    moved to points0's device if they lie elsewhere."""
    group = global_obs_mesh() if group is None else group

    def solve(poses0, points0, work: DistLoopWork, fixed_mask, costs=None):
        device = points0.device
        bw = rank_slice(work.banded_local, group, device)
        lc = work.lc
        if lc.lc_w.device != device:
            lc = make_global_array(lc._replace(banded=None), group, device)
        final = loop_flat.solve_ba_loop(
            poses0, points0, lc._replace(banded=bw), fixed_mask=fixed_mask,
            max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
            loss=loss, costs=costs, psum_axis=group, raw_points=True)
        pts_sr, pts_lc = final.points
        points = gather_owned(points0, bw.scatter_idx, pts_sr, group)
        return final._replace(points=scatter_slots(points, pts_lc, lc.lc_lm))

    return solve
