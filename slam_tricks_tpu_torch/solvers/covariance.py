"""Posterior covariances after a BA solve, the Ceres ``Covariance`` role
(port of ``slam_tricks_tpu/solvers/covariance.py``).

Pose marginals are the diagonal blocks of the inverse of the gauge-fixed
reduced camera system S (the landmarks already marginalized out); landmark
marginals follow from the back-substitution identity

    Cov(l) = Hll^-1 + Hll^-1 Wᵀ S^-1 W Hll^-1   (restricted to landmark l).

Dense in (C, L): for small and medium problems
(``banded_flat.banded_covariances`` is the large-C route).
"""

import torch

from slam_tricks_tpu_torch.solvers import schur
from slam_tricks_tpu_torch.solvers.common import sum_table, table_sum


def ba_covariances(poses, points, obs, fixed_mask, *, lam=0.0,
                   compute_landmarks=False):
    """Marginal covariances at the solution: (pose_cov (C, 6, 6), point_cov
    (L, 3, 3) or None). Fixed cameras get zero covariance. `lam` adds
    Marquardt damping (0: the Gauss-Newton covariance)."""
    C, L = poses.t.shape[0], points.shape[0]
    dtype, device = points.dtype, points.device
    cam, lm = obs.cam_idx.long(), obs.lm_idx.long()
    tables = schur.obs_tables(obs.cam_idx, obs.lm_idx, C, L, obs.weight)
    r, Jp, Jl = schur._linearize_obs(poses, points, obs.cam_idx, obs.lm_idx,
                                     obs.uv, obs.weight)
    Hpp, Hll, _, _, W_obs = schur._assemble(r, Jp, Jl, obs.cam_idx,
                                            obs.lm_idx, C, L, tables)

    lam = torch.tensor(lam, dtype=dtype, device=device)
    Hpp_d = schur._damp_blocks(Hpp, lam)
    # a landmark with no (weighted) observation: the identity, so that its
    # inverse stays finite (its W is zero either way)
    no_obs = torch.einsum("lii->l", Hll) <= 0.0
    Hll_d = torch.where(no_obs[:, None, None],
                        torch.eye(3, dtype=dtype, device=device)[None],
                        schur._damp_blocks(Hll, lam))
    Hll_inv = schur._inv3x3(Hll_d)

    live = obs.weight > 0
    W = table_sum(W_obs.reshape(-1, 18).T,
                  sum_table(torch.where(live, cam * L + lm, -1), C * L))
    W = W.reshape(C, L, 6, 3)
    WHinv = torch.einsum("clij,ljk->clik", W, Hll_inv)
    S = -torch.einsum("clik,elmk->ciem", WHinv, W)
    ci = torch.arange(C, device=device)
    S[ci, :, ci, :] += Hpp_d
    free = (~fixed_mask).to(dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[ci, :, ci, :] += (fixed_mask.to(dtype)[:, None, None]
                        * torch.eye(6, dtype=dtype, device=device))

    S_inv4 = torch.linalg.inv(S.reshape(6 * C, 6 * C)).reshape(C, 6, C, 6)
    pose_cov = S_inv4[ci, :, ci, :] * free[:, None, None]
    if not compute_landmarks:
        return pose_cov, None

    # Cov(l) = Hll_inv + sum over c, e of (Hll^-1 W_clᵀ) Sinv[c, e]
    # (Hll^-1 W_elᵀ)ᵀ; the fixed cameras' identity rows of S give Sinv
    # spurious blocks there, so their terms are masked out
    HW = torch.einsum("lik,cljk->clij", Hll_inv, W) * free[:, None, None, None]
    T = torch.einsum("clij,cjem->liem", HW, S_inv4)
    point_cov = Hll_inv + torch.einsum("liem,elkm->lik", T, HW)
    return pose_cov, point_cov
