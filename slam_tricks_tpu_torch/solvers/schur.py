"""LM state, the track table, the LM control law and the LM loop that the
Schur solvers share (the subset of ``slam_tricks_tpu/solvers/schur.py``
that the slot-major and banded solvers use)."""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.manifolds import se3, so3


class BAState(NamedTuple):
    poses: se3.SE3          # stacked (C,)
    points: torch.Tensor    # (L, 3)
    cost: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    it: int                 # LM iterations run
    done: bool              # stopped on the step-size test


class TrackTable(NamedTuple):
    """obs_idx[l, k] is the k-th observation of landmark l in the flat
    observation arrays; mask marks the real entries. numpy, host side."""
    obs_idx: np.ndarray     # (L, K) int32
    mask: np.ndarray        # (L, K) 1/0


def build_track_table(cam_idx, lm_idx, weight=None, *, n_points=None,
                      dtype=np.float32):
    """Group observation indices by landmark (stable, in input order) and pad
    to the longest track rounded up to a multiple of 8. Padding entries
    point at observation 0 with mask 0."""
    lm_idx = np.asarray(lm_idx)
    keep = (np.ones(lm_idx.shape[0], bool) if weight is None
            else np.asarray(weight) > 0)
    L = int(n_points) if n_points is not None else int(lm_idx.max()) + 1
    valid = np.flatnonzero(keep)
    order = valid[np.argsort(lm_idx[valid], kind="stable")]
    lm_sorted = lm_idx[order]
    counts = np.bincount(lm_sorted, minlength=L)
    K = int(counts.max()) if counts.size else 1
    K = K + (-K) % 8
    obs_idx = np.zeros((L, K), np.int32)
    mask = np.zeros((L, K), dtype)
    starts = np.zeros(L + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # each sorted observation lands at (its landmark, its rank in the track)
    slot = np.arange(lm_sorted.shape[0]) - starts[lm_sorted]
    obs_idx[lm_sorted, slot] = order
    mask[lm_sorted, slot] = 1
    return TrackTable(obs_idx=obs_idx, mask=mask)


def lm_accept(cost_old, cost_try, lam, nu, pred, bad):
    """Nielsen gain-ratio trust-region update, the control law every LM loop
    of the JAX package shares. pred is the predicted model decrease.

    Returns (accept, lam_new, nu_new), all tensors on the device."""
    rho = (cost_old - cost_try) / torch.clamp_min(pred, 1e-30)
    accept = (cost_try < cost_old) & torch.isfinite(cost_try) & (~bad)
    lam_new = torch.where(
        accept,
        lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0),
        lam * nu)
    lam_new = torch.clamp(lam_new, 1e-12, 1e10)
    nu_new = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    return accept, lam_new, nu_new


def lm_loop(poses0, points0, quantities, solve, *, max_iters,
            lambda_init=1e-4, xtol=1e-12, costs=None):
    """The Levenberg-Marquardt loop of the JAX package's Schur solvers, run
    on the host over device tensors with one sync (the stop flag) a step.

    quantities(poses, points) -> (blocks, cost), blocks a tuple of tensors
    in the solver's layout that starts (Hpp, gp, Hll, gl (3, L), ...);
    solve(blocks, lam) -> (dp (C, 6), dl (L, 3), diag_pp (C, 6),
    diag_ll (L, 3)). Steps retract on SO(3) x R^3 (tangent [omega, dt]);
    the predicted reduction uses the Marquardt diagonals. lambda_init is
    the first damping; the loop stops when an accepted step is shorter
    than xtol. If `costs` is a list, the cost at the start and after each
    step is appended to it (device scalars). Returns a BAState."""
    dtype, device = points0.dtype, points0.device
    poses, points = poses0, points0
    blocks, cost = quantities(poses, points)
    lam = torch.tensor(lambda_init, dtype=dtype, device=device)
    nu = torch.tensor(2.0, dtype=dtype, device=device)
    it, done = 0, False
    if costs is not None:
        costs.append(cost)
    while not done and it < max_iters:
        gp, gl = blocks[1], blocks[3]
        dp, dl, diag_pp, diag_ll = solve(blocks, lam)
        bad = ~(torch.isfinite(dp).all() & torch.isfinite(dl).all())
        dp_s = torch.where(bad, torch.zeros_like(dp), dp)
        dl_s = torch.where(bad, torch.zeros_like(dl), dl)
        poses_try = se3.SE3(so3.retract(poses.R, dp_s[:, :3]),
                            poses.t + dp_s[:, 3:])
        points_try = points + dl_s
        blocks_try, cost_try = quantities(poses_try, points_try)

        pred_l = torch.sum(dl_s * (lam * diag_ll * dl_s - gl.T))
        pred = 0.5 * (torch.sum(dp_s * (lam * diag_pp * dp_s - gp)) + pred_l)
        accept, lam, nu = lm_accept(cost, cost_try, lam, nu, pred, bad)
        step_sq = torch.sum(dp_s * dp_s) + torch.sum(dl_s * dl_s)
        poses = se3.SE3(torch.where(accept, poses_try.R, poses.R),
                        torch.where(accept, poses_try.t, poses.t))
        points = torch.where(accept, points_try, points)
        cost = torch.where(accept, cost_try, cost)
        blocks = tuple(torch.where(accept, a, b)
                       for a, b in zip(blocks_try, blocks))
        it += 1
        if costs is not None:
            costs.append(cost)
        done = bool(accept & (step_sq < xtol * xtol))   # one sync a step
    return BAState(poses=poses, points=points, cost=cost, lam=lam, nu=nu,
                   it=it, done=done)
