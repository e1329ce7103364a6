"""Distributed slot-major banded trajectory BA (port of
``slam_tricks_tpu/parallel/banded_dist.py``): the exact large-C solve of
``solvers/banded_flat`` over a process group, with pose-sized sums
between the ranks.

The slot-major layout already sorts the landmarks into chunks by their
first camera, so distribution splits the chunk axis: rank d owns a
contiguous run of chunks, and with them its landmarks and all their
observations. Each rank runs ``banded_flat.solve_ba_banded`` on its slice
with ``psum_axis`` set:

- the landmark state, the slot grids and all per-slot algebra are the
  rank's own, ``ba_assemble`` (the CUDA kernel on the card) linearizes its
  slice;
- an LM iteration sums over the ranks, each by one ``all_reduce``: Hpp,
  gp and the cost ((C, 27) + 1) at each linearization, the K band
  downdates (K, C, 36) and the rhs (C, 6) at the solve, and three scalars,
  whatever L and N;
- the super-block tridiagonal solve is replicated (``tridiag_solve``, the
  CUDA kernel on the card).

The port's ``BandedWork`` is not the JAX one: it keeps each chunk's first
camera c0 and the sums' fixed order (``cam_table``) and camera index, so
``split_banded_work`` cuts those, rebuilding the order and the index of
each rank's slice from that slice.
"""

from typing import NamedTuple

import torch
import torch.distributed as dist

from slam_tricks_tpu_torch.ops.ba_assemble import layout_index
from slam_tricks_tpu_torch.parallel.multihost import (gather_owned,
                                                      global_obs_mesh,
                                                      make_global_array)
from slam_tricks_tpu_torch.solvers import banded_flat
from slam_tricks_tpu_torch.solvers.banded_flat import (BandedWork,
                                                       build_banded_work,
                                                       chunk_table)


class DistBandedWork(NamedTuple):
    """Each rank's BandedWork slice (rank d takes local[d])."""
    local: tuple
    n_points: int


def build_dist_banded_work(obs, n_cams, n_points, n_devices,
                           dtype=torch.float32, chunk=32, max_band=32):
    """The whole problem's slot-major layout (``build_banded_work``), its
    chunk axis padded to a multiple of n_devices and split into equal
    contiguous slices. Pad chunks carry weight 0 and sentinel scatter ids,
    so they add nothing and scatter nowhere."""
    bw = build_banded_work(obs, n_cams, n_points, dtype=dtype, chunk=chunk,
                           max_band=max_band)
    return DistBandedWork(local=split_banded_work(bw, n_points, n_devices),
                          n_points=int(n_points))


def split_banded_work(bw: BandedWork, n_points, n_devices):
    """The chunk axis of `bw` in n_devices contiguous slices, the JAX
    package's cut: padded at the end with weight-0 chunks (c0 = 0, scatter
    id n_points, gather id n_points - 1) to a multiple of n_devices.
    Returns a tuple of BandedWork, one a rank, each with its own
    ``cam_table`` and camera index built from its slice, on `bw`'s
    device. Shared by the banded and the loop-closure wrappers."""
    device = bw.w.device
    K = bw.w.shape[0]
    C = bw.n_cams
    chunk = bw.chunk
    LB = bw.c0.shape[0]
    pad_chunks = (-LB) % n_devices
    uv0, uv1, w = bw.uv0, bw.uv1, bw.w
    c0, sc, ga = bw.c0, bw.scatter_idx, bw.gather_idx
    if pad_chunks:
        pl = pad_chunks * chunk
        uv0, uv1, w = (torch.cat([a, a.new_zeros((K, pl))], dim=1)
                       for a in (uv0, uv1, w))
        c0 = torch.cat([c0, c0.new_zeros(pad_chunks)])
        sc = torch.cat([sc, sc.new_full((pl,), n_points)])
        ga = torch.cat([ga, ga.new_full((pl,), max(n_points - 1, 0))])
        LB += pad_chunks
    LBd = LB // n_devices
    Ld = LBd * chunk
    out = []
    for d in range(n_devices):
        s = slice(d * Ld, (d + 1) * Ld)
        c0_d = c0[d * LBd:(d + 1) * LBd].contiguous()
        slot_c0 = c0_d.repeat_interleave(chunk)
        cam = ((slot_c0[None, :] + torch.arange(K, device=device)[:, None])
               % C).to(torch.int32)
        w_d = w[:, s].contiguous()
        out.append(BandedWork(
            uv0=uv0[:, s].contiguous(), uv1=uv1[:, s].contiguous(), w=w_d,
            cam_of_slot=cam, cam_index=layout_index(w_d, cam, C),
            cam_table=chunk_table(c0_d, K, C), c0=c0_d,
            scatter_idx=sc[s].contiguous(), gather_idx=ga[s].contiguous(),
            n_cams=C, n_points=int(n_points)))
    return tuple(out)


def rank_slice(local, group, device):
    """The rank's element of the per-rank tuple `local`, on `device` (moved
    there, camera index rebuilt, when it lies elsewhere)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if len(local) != size:
        raise ValueError(f"the work is split {len(local)} ways, the group "
                         f"has {size} ranks")
    mine = local[rank]
    if mine.w.device != device:
        mine = make_global_array(mine, group, device)
    return mine


def make_ba_solver_banded_dist(group=None, *, max_iters=30, lambda_init=1e-4,
                               xtol=1e-12, loss=None):
    """Distributed exact banded BA over the ranks of `group` (None: the
    world). Returns solve(poses0, points0, work: DistBandedWork,
    fixed_mask, costs=None) -> BAState with the global points, the same on
    every rank, called on every rank with the same arguments; the LM
    control and trajectory are the single-process solver's (up to the
    summation order across ranks). A rank's slice is moved to points0's
    device if it lies elsewhere; `costs` as in ``schur.lm_loop``."""
    group = global_obs_mesh() if group is None else group

    def solve(poses0, points0, work: DistBandedWork, fixed_mask, costs=None):
        bw = rank_slice(work.local, group, points0.device)
        final = banded_flat.solve_ba_banded(
            poses0, points0, bw, fixed_mask=fixed_mask, max_iters=max_iters,
            lambda_init=lambda_init, xtol=xtol, loss=loss, costs=costs,
            psum_axis=group, slot_points=True)
        return final._replace(points=gather_owned(
            points0, bw.scatter_idx, final.points, group))

    return solve
