"""Distributed bundle adjustment: observation-sharded LM over a process
group (port of ``slam_tricks_tpu/parallel/sharded_ba.py``).

The observations are split over the ranks at landmark-track boundaries
(``parallel/partition``); each rank linearizes its rows and builds partial
normal-equation blocks. Three rounds of sums over the ranks an LM
iteration, each one ``all_reduce`` (``solvers.common.psum``):

1. the full blocks: Hpp (C, 6, 6), Hll (L, 3, 3), gp (C, 6), gl (L, 3),
   and the cost (at the start and at each trial state, whose blocks the
   loop keeps when it accepts the step);
2. the paired off-diagonal Schur mass M (C, C, 6, 6), from each rank's
   within-track pairs (``schur._paired_S_mass``), and the rhs's landmark
   part (C, 6);
3. the back-substitution's Wᵀ dp (L, 3).

The reduced camera system is solved on every rank alike
(``schur._finish_and_solve_S``: ``ops.spd_solve``, the CUDA kernel on the
card), and the LM control is the single-process solvers' loop
(``schur.lm_loop``), every decision taken from summed or replicated
numbers, so that the ranks leave the loop together. Where the JAX package
runs one program over the mesh (``shard_map`` and ``psum``), the port runs
one process a rank, and the loop on the host reads one stop flag a step.

``parallel/landmark_local`` keeps the landmark blocks rank-local and sums
only pose-sized terms and dl; this path sums (Hll, gl) and eliminates the
landmarks on every rank: simpler, more traffic.
"""

import torch
import torch.distributed as dist

from slam_tricks_tpu_torch.parallel.multihost import global_obs_mesh
from slam_tricks_tpu_torch.parallel.partition import (  # noqa: F401
    build_local_pairs,
    partition_obs_by_landmark,
)
from slam_tricks_tpu_torch.solvers import schur
from slam_tricks_tpu_torch.solvers.common import (psum, set_full_precision,
                                                  table_sum)
from slam_tricks_tpu_torch.solvers.schur import TrackPairs


def pad_obs_to_multiple(obs, n_devices):
    """Observations padded with weight-0 rows at indices 0 so that their
    count divides n_devices. The BA solvers need track locality and take
    ``partition_obs_by_landmark``'s layout instead; this one serves any
    sum over rows split evenly (a cost over arbitrary shards)."""
    n = obs.cam_idx.shape[0]
    pad = (-n) % n_devices
    if pad == 0:
        return obs
    return type(obs)(*(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
                       for a in obs))


def rank_rows(obs, pairs, group):
    """This rank's rows of the partitioned observations `obs`
    (``partition_obs_by_landmark``) and its slice of `pairs`
    (``build_local_pairs``), as (observations, TrackPairs)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    n_total = obs.cam_idx.shape[0]
    if n_total % size or pairs.pair_a.shape[0] != size:
        raise ValueError(f"{n_total} observations and pairs for "
                         f"{pairs.pair_a.shape[0]} ranks do not split over "
                         f"{size} ranks")
    n = n_total // size
    local = type(obs)(*(a[rank * n:(rank + 1) * n] for a in obs))
    return local, TrackPairs(*(a[rank] for a in pairs))


def make_ba_solver(group=None, *, max_iters=30, lambda_init=1e-4,
                   xtol=1e-12):
    """The distributed BA solver over the ranks of `group` (a
    ``torch.distributed`` process group; None: every rank, the world).

    Returns solve(poses0, points0, obs, pairs, fixed_mask, costs=None) ->
    BAState, called on every rank with the same arguments: obs from
    ``partition_obs_by_landmark(obs, n_ranks)`` (padding rows have weight
    0), pairs from ``build_local_pairs(obs, n_ranks)``; each rank takes its
    own rows and pairs. Tensors on the rank's device; `costs` as in
    ``schur.lm_loop``."""
    group = global_obs_mesh() if group is None else group

    def solve(poses0, points0, obs, pairs, fixed_mask, costs=None):
        set_full_precision()
        C, L = poses0.t.shape[0], points0.shape[0]
        local, pr = rank_rows(obs, pairs, group)
        cam_idx, lm_idx, uv, weight = local
        cam, lm = cam_idx.long(), lm_idx.long()
        tables = schur.obs_tables(cam_idx, lm_idx, C, L, weight)
        segs = schur.pair_segments(pr, cam_idx, C)

        def quantities(poses, points):
            r, Jp, Jl = schur._linearize_obs(poses, points, cam_idx, lm_idx,
                                             uv, weight)
            Hpp_p, Hll_p, gp_p, gl_p, W_obs = schur._assemble(
                r, Jp, Jl, cam_idx, lm_idx, C, L, tables)
            # round 1: the full normal-equation blocks and the cost
            Hpp, Hll, gp, gl, cost = psum(
                (Hpp_p, Hll_p, gp_p, gl_p, schur._cost(poses, points,
                                                       *local)), group)
            return (Hpp, Hll, gp, gl, W_obs), cost

        def solve_step(blocks, lam):
            Hpp, Hll, gp, gl, W_obs = blocks
            Hpp_d = schur._damp_blocks(Hpp, lam)
            Hll_inv = schur._inv3x3(schur._damp_hll(Hll, lam))

            # the off-diagonal Schur mass over the rank's within-track pairs
            # (track locality puts every pair on one rank) and the rhs's
            # landmark part over its rows
            Y = torch.einsum("nij,njk->nik", W_obs, Hll_inv[lm])
            M_p = schur._paired_S_mass(Y, W_obs, segs, C)
            u = torch.einsum("lij,lj->li", Hll_inv, gl)
            b_lm_p = table_sum(torch.einsum("nij,nj->in", W_obs, u[lm]),
                               tables.cam)
            # round 2
            M, b_lm = psum((M_p, b_lm_p), group)
            S_off = -(M + M.permute(1, 0, 3, 2)).permute(0, 2, 1, 3)
            dp = schur._finish_and_solve_S(S_off, Hpp_d, -(gp - b_lm),
                                           fixed_mask)       # replicated

            # round 3: the back-substitution's sum of Wᵀ dp per landmark
            t, = psum((table_sum(torch.einsum("nij,ni->jn", W_obs, dp[cam]),
                                 tables.lm),), group)
            dl = torch.einsum("lij,lj->li", Hll_inv, -gl - t)
            diag_pp = torch.clamp_min(
                torch.diagonal(Hpp, dim1=-2, dim2=-1), 1e-12)
            diag_ll = torch.clamp_min(
                torch.diagonal(Hll, dim1=-2, dim2=-1), 1e-12)
            return dp, dl, diag_pp, diag_ll

        # every block, dp and dl are summed or replicated, so the loop's
        # own decisions are the same on every rank without a collective
        return schur.lm_loop(poses0, points0, quantities, solve_step,
                             max_iters=max_iters, lambda_init=lambda_init,
                             xtol=xtol, costs=costs,
                             grads=lambda blocks: (blocks[2], blocks[3]))

    return solve
