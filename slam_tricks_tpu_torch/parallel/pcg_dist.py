"""Distributed large-C BA by flat-layout PCG, with pose-sized sums between
the ranks (port of ``slam_tricks_tpu/parallel/pcg_dist.py``).

The replicated paths (``sharded_ba``, ``landmark_local``) sum a dense
(C, C, 6, 6) mass and factor the 6C x 6C system on every rank, so large C
and many ranks exclude each other. This path runs the exact flat-layout
PCG solver (``schur_flat.solve_ba_flat(linear="pcg", psum_axis=...)``) on
each rank instead:

- the observations are partitioned by landmark (``parallel/partition``):
  every landmark's whole track, its blocks, its elimination and its state
  are one rank's own;
- the cameras are replicated, and the only sums over the ranks are

  ======================  ===============================================
  (C, 27) + 1             a linearization (Hpp, gp, cost)
  (C, 6, 6), (C-1, 6, 6)  a linearization (the tridiagonal preconditioner)
  (C, 6)                  a CG iteration (the product's camera sums)
  (C, 6) and scalars      an LM iteration (rhs, model decrease, step, bad)
  ======================  ===============================================

  none of which grows with L or N;
- the preconditioner's factor and the CG recurrences are replicated.

``build_dist_work`` lays out each rank's observations on their own slot
grid with rank-local landmark ids, padded to the JAX package's common
shapes, so that each rank's work equals the port's conversion of the JAX
package's slice of that rank.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from slam_tricks_tpu_torch.parallel.multihost import (gather_owned,
                                                      global_obs_mesh,
                                                      make_global_array)
from slam_tricks_tpu_torch.parallel.partition import (  # noqa: F401
    partition_obs_by_landmark,
)
from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
from slam_tricks_tpu_torch.solvers import schur_flat
from slam_tricks_tpu_torch.solvers.pcg_flat import (pcg_tables,
                                                    pcg_work_from_tables)
from slam_tricks_tpu_torch.solvers.schur import TrackTable, build_track_table
from slam_tricks_tpu_torch.solvers.schur_flat import (flat_work_from_table,
                                                      obs_slots)


class DistPCGWork(NamedTuple):
    """Each rank's observation rows and flat and PCG layouts. Tables index
    the rank's rows and its local landmark slots; camera ids stay global
    (cameras are replicated)."""
    obs_cam: torch.Tensor     # (D, n) int32 camera of each local row
    obs_lm: torch.Tensor      # (D, n) int32 local landmark slot of the row
    obs_uv: torch.Tensor      # (D, n, 2)
    obs_w: torch.Tensor       # (D, n)
    flat: tuple               # each rank's schur_flat.FlatWork
    pcg: tuple                # each rank's pcg_flat.PCGWork
    lm_global: torch.Tensor   # (D, Lp) int64 global landmark id, L = padding
    n_points_local: int       # Lp
    n_points: int             # L


def _pad_to(a, shape, fill=0):
    out = np.full(shape, fill, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def build_dist_work(obs_part, n_cams, n_points, n_devices,
                    dtype=torch.float32):
    """Each rank's observation rows of `obs_part`
    (``partition_obs_by_landmark(obs, n_devices)``), with local landmark
    ids, its track table and PCG tables padded to the largest rank's
    shapes (the JAX package's stacked layout), as FlatWork and PCGWork on
    the observations' device."""
    device = obs_part.uv.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cam = obs_part.cam_idx.cpu().numpy()
    lm = obs_part.lm_idx.cpu().numpy()
    uv = obs_part.uv.cpu().numpy()
    w = obs_part.weight.cpu().numpy()
    n_total = cam.shape[0]
    if n_total % n_devices:
        raise ValueError(f"{n_total} observations do not split into "
                         f"{n_devices} equal runs")
    n = n_total // n_devices

    per = []
    for d in range(n_devices):
        sl = slice(d * n, (d + 1) * n)
        valid = w[sl] > 0
        gid = np.unique(lm[sl][valid])
        lml = np.zeros(n, np.int32)
        lml[valid] = np.searchsorted(gid, lm[sl][valid]).astype(np.int32)
        table = build_track_table(cam[sl], lml, w[sl],
                                  n_points=max(int(gid.shape[0]), 1),
                                  dtype=np_dtype)
        per.append((lml, gid, table,
                    pcg_tables(cam[sl], lml, w[sl], n_cams, np_dtype)))

    Lp = max(t.obs_idx.shape[0] for _, _, t, _ in per)
    K = max(t.obs_idx.shape[1] for _, _, t, _ in per)
    pcg_shapes = [tuple(max(p[i].shape[j] for _, _, _, p in per)
                        for j in range(2)) for i in range(5)]
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    flat, pcg, lml_all = [], [], []
    for d, (lml, gid, table, tables) in enumerate(per):
        sl = slice(d * n, (d + 1) * n)
        table = TrackTable(obs_idx=_pad_to(table.obs_idx, (Lp, K)),
                           mask=_pad_to(table.mask, (Lp, K)))
        obs_d = BAObservations(cam_idx=t(cam[sl]), lm_idx=t(lml),
                               uv=t(uv[sl]), weight=t(w[sl]))
        flat.append(flat_work_from_table(obs_d, table, n_cams, dtype,
                                         use_cam_table=True))
        pcg.append(pcg_work_from_tables(
            tuple(_pad_to(a, s) for a, s in zip(tables, pcg_shapes)),
            obs_slots(table), Lp, device, dtype))
        lml_all.append(lml)
    lm_global = np.full((n_devices, Lp), n_points, np.int64)
    for d, (_, gid, _, _) in enumerate(per):
        lm_global[d, :gid.shape[0]] = gid
    return DistPCGWork(
        obs_cam=t(cam.reshape(n_devices, n)), obs_lm=t(np.stack(lml_all)),
        obs_uv=t(uv.reshape(n_devices, n, 2)),
        obs_w=t(w.reshape(n_devices, n)), flat=tuple(flat), pcg=tuple(pcg),
        lm_global=t(lm_global), n_points_local=int(Lp),
        n_points=int(n_points))


def make_ba_solver_pcg_dist(group=None, *, max_iters=30, lambda_init=1e-4,
                            xtol=1e-12, cg_iters=100, cg_tol=1e-6, loss=None):
    """Distributed large-C flat-PCG BA over the ranks of `group` (None: the
    world). Returns solve(poses0, points0, work: DistPCGWork, fixed_mask,
    costs=None) -> BAState with the global points, the same on every rank,
    called on every rank with the same arguments: each rank runs the LM
    loop of ``schur_flat.solve_ba_flat`` (the single-process control law)
    on its own rows, landmarks and layouts, moved to points0's device if
    they lie elsewhere. `costs` as in ``schur.lm_loop``."""
    group = global_obs_mesh() if group is None else group

    def solve(poses0, points0, work: DistPCGWork, fixed_mask, costs=None):
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        if len(work.flat) != size:
            raise ValueError(f"the work is split {len(work.flat)} ways, the "
                             f"group has {size} ranks")
        obs, flat, pcgw, lm_global = make_global_array(
            (BAObservations(work.obs_cam[rank], work.obs_lm[rank],
                            work.obs_uv[rank], work.obs_w[rank]),
             work.flat[rank], work.pcg[rank], work.lm_global[rank]),
            group, points0.device)
        # the rank's landmarks in its slot order; a padding slot takes
        # landmark L - 1's point (its blocks are empty: dl = 0)
        own0 = points0[lm_global.clamp(0, work.n_points - 1)]
        final = schur_flat.solve_ba_flat(
            poses0, own0, obs, flat, fixed_mask=fixed_mask,
            max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
            linear="pcg", pcg_work=pcgw, cg_iters=cg_iters, cg_tol=cg_tol,
            loss=loss, psum_axis=group, costs=costs)
        return final._replace(points=gather_owned(points0, lm_global,
                                                  final.points, group))

    return solve
