"""Landmark-local distributed BA (port of
``slam_tricks_tpu/parallel/landmark_local.py``): the observations are split
so that all observations of a landmark live on one rank
(``parallel/partition``), so a landmark's Hessian block, its elimination
and the within-track pair products of the off-diagonal Schur mass are the
rank's own. The sums over the ranks an LM iteration, each one
``all_reduce``, are

    (Hpp (C, 6, 6), gp (C, 6), the cost) at the trial state,
    (M (C, C, 6, 6), b_lm (C, 6)), the bad-step flag, and the landmark
    part of the model decrease and of the step's length,

O(C² 36) values, no (C, L, 6, 3) tensor anywhere; the JAX package sums dl
(L, 3) every iteration instead, where the port keeps each rank's steps on
its own landmarks and sums the points once, after the loop
(``multihost.gather_owned``). The reduced camera system is solved on every
rank alike (``ops.spd_solve``, the CUDA kernel on the card) and the LM
control is the single-process solvers' loop (``schur.lm_loop`` with the
group), so the distributed and the single-process solves take the same
steps.
"""

import torch

from slam_tricks_tpu_torch.parallel.multihost import (gather_owned,
                                                      global_obs_mesh)
from slam_tricks_tpu_torch.parallel.partition import (  # noqa: F401
    LocalPairs,
    build_local_pairs,
    partition_obs_by_landmark,
)
from slam_tricks_tpu_torch.parallel.sharded_ba import rank_rows
from slam_tricks_tpu_torch.solvers import schur
from slam_tricks_tpu_torch.solvers.common import (psum, set_full_precision,
                                                  table_sum)


def make_ba_solver_landmark_local(group=None, *, max_iters=30,
                                  lambda_init=1e-4, xtol=1e-12):
    """Distributed BA with landmark-local elimination over the ranks of
    `group` (None: the world). Observations from
    ``partition_obs_by_landmark(obs, n_ranks)``, pairs from
    ``build_local_pairs(obs, n_ranks)``.

    Returns solve(poses0, points0, obs, pairs, fixed_mask, costs=None) ->
    BAState, called on every rank with the same arguments."""
    group = global_obs_mesh() if group is None else group

    def solve(poses0, points0, obs, pairs, fixed_mask, costs=None):
        set_full_precision()
        C, L = poses0.t.shape[0], points0.shape[0]
        dtype, device = points0.dtype, points0.device
        local_obs, pr = rank_rows(obs, pairs, group)
        cam_idx, lm_idx, uv, weight = local_obs
        cam, lm = cam_idx.long(), lm_idx.long()
        tables = schur.obs_tables(cam_idx, lm_idx, C, L, weight)
        segs = schur.pair_segments(pr, cam_idx, C)
        eye3 = torch.eye(3, dtype=dtype, device=device)

        def quantities(poses, points):
            r, Jp, Jl = schur._linearize_obs(poses, points, cam_idx, lm_idx,
                                             uv, weight)
            Hpp_p, Hll, gp_p, gl, W_obs = schur._assemble(
                r, Jp, Jl, cam_idx, lm_idx, C, L, tables)
            # round 1: the camera blocks and the cost, O(C 42)
            Hpp, gp, cost = psum((Hpp_p, gp_p, schur._cost(
                poses, points, *local_obs)), group)
            return (Hpp, Hll, gp, gl, W_obs), cost

        def solve_step(blocks, lam):
            Hpp, Hll, gp, gl, W_obs = blocks
            # a landmark observed here has its whole Hll here; a foreign
            # one has zero blocks, W and gl, and gets the identity so that
            # its inverse stays finite (it adds nothing)
            local = torch.einsum("lii->l", Hll) > 0.0
            Hll_d = torch.where(local[:, None, None],
                                schur._damp_blocks(Hll, lam), eye3[None])
            Hll_inv = schur._inv3x3(Hll_d)

            Y = torch.einsum("nij,njk->nik", W_obs, Hll_inv[lm])
            M_p = schur._paired_S_mass(Y, W_obs, segs, C)
            u = torch.einsum("lij,lj->li", Hll_inv, gl)
            b_lm_p = table_sum(torch.einsum("nij,nj->in", W_obs, u[lm]),
                               tables.cam)
            # round 2: the off-diagonal Schur mass and the rhs's landmark
            # part, O(C² 36)
            M, b_lm = psum((M_p, b_lm_p), group)
            Hpp_d = schur._damp_blocks(Hpp, lam)
            S_off = -(M + M.permute(1, 0, 3, 2)).permute(0, 2, 1, 3)
            dp = schur._finish_and_solve_S(S_off, Hpp_d, -(gp - b_lm),
                                           fixed_mask)       # replicated

            # the rank's landmarks: dl = Hll^-1 (-gl - Wᵀ dp), 0 elsewhere
            t = table_sum(torch.einsum("nij,ni->jn", W_obs, dp[cam]),
                          tables.lm)
            dl = torch.where(
                local[:, None], torch.einsum("lij,lj->li", Hll_inv, -gl - t),
                0.0)
            diag_pp = torch.clamp_min(
                torch.diagonal(Hpp, dim1=-2, dim2=-1), 1e-12)
            diag_ll = torch.clamp_min(
                torch.diagonal(Hll, dim1=-2, dim2=-1), 1e-12)
            return dp, dl, diag_pp, diag_ll

        # the loop sums the step's landmark terms and its bad flag over the
        # ranks (dl is the rank's own); each rank moves only its landmarks
        final = schur.lm_loop(poses0, points0, quantities, solve_step,
                              max_iters=max_iters, lambda_init=lambda_init,
                              xtol=xtol, costs=costs,
                              grads=lambda blocks: (blocks[2], blocks[3]),
                              psum_axis=group)
        owned = torch.zeros(L, dtype=torch.bool, device=device)
        owned[lm[weight > 0]] = True
        ids = torch.nonzero(owned).squeeze(1)
        return final._replace(points=gather_owned(points0, ids,
                                                  final.points[ids], group))

    return solve
