"""Sliding-window bundle adjustment with marginalization priors, the online
SLAM estimator (port of ``slam_tricks_tpu/solvers/sliding_window.py``).

A window of `window` consecutive cameras is solved with the flat Schur LM
solver plus a Gaussian prior on its first `na` cameras, the information
left behind by everything marginalized so far. When the window advances by
`shift`, the dropped cameras and every track wholly inside the dropped span
are Schur-eliminated into a new dense prior on the next `na` cameras;
tracks that straddle the boundary keep only their in-window observations
(no double counting).

Prior: E(x) = 1/2 (xi - xi0)ᵀ H (xi - xi0), xi the right-tangent local
coordinates of the head poses at stored anchors (omega = log(Raᵀ R),
dt = t - ta: the solver's retraction).

The prior is formed, kept and evaluated in float64 whatever the window's
dtype (``PRIOR_DTYPE``; the same arithmetic as the JAX package's in a
float64 run). Along the scale that no camera fixes it holds only the
eps = 1e-6 of its solves, far below float32's resolution relative to its
largest eigenvalues. A float32 prior comes out indefinite there, a
window's cost goes negative and the solve can run off along the scale
(``tools/sweep_precision.py --prior-dtype window``).

``run_sliding_window`` selects each window's observations on the host in
numpy; the tensors stay on the device. The JAX package pads every window
to one observation count so that one compiled solve serves all; nothing
recompiles here, so the port does not pad (padding has weight 0 and
changes no result).
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import se3, so3
from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
from slam_tricks_tpu_torch.solvers import schur
from slam_tricks_tpu_torch.solvers.common import (set_full_precision,
                                                  sum_table, table_sum)
from slam_tricks_tpu_torch.solvers.schur import lm_loop
from slam_tricks_tpu_torch.solvers.schur_flat import (_check_obs,
                                                      _iteration_quantities,
                                                      _solve_flat,
                                                      build_flat_work)
from slam_tricks_tpu_torch.solvers.schur_flat_sm import with_b_table


PRIOR_DTYPE = torch.float64


class WindowPrior(NamedTuple):
    H: torch.Tensor          # (P, P) information on the first P // 6 cameras
    xi0: torch.Tensor        # (P,) the prior mean in local coordinates
    anchor_R: torch.Tensor   # (na, 3, 3) linearization rotations
    anchor_t: torch.Tensor   # (na, 3)


def empty_prior(na, dtype=None, device=None):
    """The zero prior on na cameras (dtype None: ``PRIOR_DTYPE``), on
    `device` (the card unless the caller names another)."""
    device = resolve(device)
    dtype = PRIOR_DTYPE if dtype is None else dtype
    P = 6 * na
    return WindowPrior(H=torch.zeros((P, P), dtype=dtype, device=device),
                       xi0=torch.zeros(P, dtype=dtype, device=device),
                       anchor_R=torch.eye(3, dtype=dtype, device=device)
                       .expand(na, 3, 3).clone(),
                       anchor_t=torch.zeros((na, 3), dtype=dtype,
                                            device=device))


def _local_xi(poses, prior: WindowPrior):
    """Right-tangent coordinates of the head poses at the prior's anchors,
    (P,) as [omega, dt] a camera."""
    na = prior.anchor_R.shape[0]
    w = so3.log(prior.anchor_R.mT @ poses.R[:na])
    dt = poses.t[:na] - prior.anchor_t
    return torch.cat([w, dt], dim=1).reshape(-1)


def _as_prior_dtype(poses):
    return se3.SE3(poses.R.to(PRIOR_DTYPE), poses.t.to(PRIOR_DTYPE))


def prior_cost_grad(poses, prior: WindowPrior):
    """The prior's cost and gradient at `poses`, computed in float64 and
    returned in the poses' dtype."""
    prior = WindowPrior(*(a.to(PRIOR_DTYPE) for a in prior))
    d = _local_xi(_as_prior_dtype(poses), prior) - prior.xi0
    g = prior.H @ d
    dtype = poses.t.dtype
    return (0.5 * torch.dot(d, g)).to(dtype), g.to(dtype)


def solve_window(poses0, points0, obs, work, prior: WindowPrior, *,
                 fixed_mask=None, max_iters=20, lambda_init=1e-4,
                 xtol=1e-12, costs=None):
    """The flat Schur LM (``schur_flat``) over one window with the
    marginalization prior on its head cameras: the prior adds its cost,
    its gradient (also in the predicted reduction) and its information to
    the camera system. `work` from ``schur_flat.build_flat_work(obs, C,
    L)``; `costs` as in ``schur.lm_loop``. Returns a BAState."""
    _check_obs(obs, work)
    set_full_precision()
    work = work._replace(slot=with_b_table(work.slot))
    C = work.slot.n_cams
    if fixed_mask is None:
        fixed_mask = torch.zeros(C, dtype=torch.bool, device=points0.device)
    P = prior.H.shape[0]
    H = prior.H.to(points0.dtype)

    def quantities(poses, points):
        *blocks, cost = _iteration_quantities(poses, points, work)
        pc, pg = prior_cost_grad(poses, prior)
        return (*blocks, pg), cost + pc

    def solve(blocks, lam):
        *blocks, pg = blocks
        return _solve_flat(*blocks, lam, fixed_mask, work,
                           prior=(H, pg))

    def grads(blocks):
        gp, gl, pg = blocks[1], blocks[3], blocks[5]
        g = gp.reshape(-1)
        return torch.cat([g[:P] + pg, g[P:]]).reshape(gp.shape), gl.T

    return lm_loop(poses0, points0, quantities, solve, max_iters=max_iters,
                   lambda_init=lambda_init, xtol=xtol, costs=costs,
                   grads=grads)


def marginalize(poses, points, obs_np, prior: WindowPrior, *, n_drop, na,
                fixed_mask=None, eps=1e-6):
    """Schur-eliminate the first `n_drop` window cameras into a new prior on
    the next `na`. Host side (numpy index selection of `obs_np`, arrays
    cam_idx, lm_idx, uv, weight in window-local camera indices) and one
    small dense Schur complement on the device of `points` (all of them).

    Only tracks wholly inside cameras [0, n_drop + na) that touch the
    dropped span carry information here; the previous prior, anchored on
    cameras inside the dropped span, is folded in at its current local
    coordinates. The new prior is formed in float64 (``PRIOR_DTYPE``).
    Returns (WindowPrior, the consumed landmark ids (numpy))."""
    cam = np.asarray(obs_np.cam_idx)
    lm = np.asarray(obs_np.lm_idx)
    w = np.asarray(obs_np.weight)
    inv = n_drop + na
    valid = w > 0
    n_lm = int(lm.max()) + 1 if lm.size else 1
    touch_drop = np.zeros(n_lm, bool)
    outside = np.zeros_like(touch_drop)
    np.logical_or.at(touch_drop, lm[valid & (cam < n_drop)], True)
    np.logical_or.at(outside, lm[valid & (cam >= inv)], True)
    use_track = touch_drop & ~outside
    sel = np.flatnonzero(valid & use_track[lm] & (cam < inv))

    dtype, device = PRIOR_DTYPE, points.device
    poses = _as_prior_dtype(poses)
    points = points.to(dtype)
    prior = WindowPrior(*(a.to(dtype) for a in prior))
    lms = np.unique(lm[sel]) if sel.size else np.zeros(1, np.int64)
    lmap = np.searchsorted(lms, lm[sel]) if sel.size else np.zeros(0)
    Lw = max(lms.size, 1)
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    cam_s = t(cam[sel].astype(np.int64))
    lm_s = t(lmap.astype(np.int64))
    uv_s = t(np.asarray(obs_np.uv)[sel], dtype)
    w_s = t(w[sel], dtype)
    pts_s = points[t(lms.astype(np.int64))]

    sub = se3.SE3(poses.R[:inv], poses.t[:inv])
    tables = schur.obs_tables(cam_s, lm_s, inv, Lw, w_s)
    r, Jp, Jl = schur._linearize_obs(sub, pts_s, cam_s, lm_s, uv_s, w_s)
    Hpp, Hll, gp, gl, W_obs = schur._assemble(r, Jp, Jl, cam_s, lm_s, inv,
                                              Lw, tables)
    # eliminate the selected landmarks (exact: all their observations are
    # here)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    tr = torch.einsum("lii->l", Hll)
    Hll_s = torch.where((tr <= 0)[:, None, None], eye3[None],
                        Hll + eps * eye3[None])
    Hll_inv = schur._inv3x3(Hll_s)
    Wd = table_sum(W_obs.reshape(-1, 18).T,
                   sum_table(cam_s * Lw + lm_s, inv * Lw))
    Wd = Wd.reshape(inv, Lw, 6, 3)
    WH = torch.einsum("clij,ljk->clik", Wd, Hll_inv)
    Hc = torch.einsum("clik,elmk->ciem", WH, Wd)
    Hfull = -Hc.reshape(inv * 6, inv * 6)
    ci = torch.arange(inv, device=device)
    Hfull = Hfull.view(inv, 6, inv, 6)
    Hfull[ci, :, ci, :] += Hpp
    Hfull = Hfull.reshape(inv * 6, inv * 6)
    gfull = (gp - torch.einsum("clik,lk->ci", WH, gl)).reshape(-1)

    # fold in the previous prior (its anchors: the head of the dropped span)
    Pp = prior.H.shape[0]
    gprev = prior.H @ (_local_xi(poses, prior) - prior.xi0)
    Hfull[:Pp, :Pp] += prior.H
    gfull[:Pp] += gprev
    # originally fixed cameras inside the drop carry a (near-)infinite prior
    if fixed_mask is not None:
        fixed_np = np.asarray(fixed_mask.cpu())[:inv]
        big = np.kron(fixed_np.astype(np.float64), np.ones(6)) * 1e8
        Hfull = Hfull + torch.diag(t(big, dtype))

    D = 6 * n_drop
    Hdd = Hfull[:D, :D] + eps * torch.eye(D, dtype=dtype, device=device)
    Had = Hfull[D:, :D]
    X = torch.linalg.solve(Hdd, torch.cat([Hfull[:D, D:], gfull[:D, None]],
                                          dim=1))
    Hnew = Hfull[D:, D:] - Had @ X[:, :-1]
    gnew = gfull[D:] - Had @ X[:, -1]
    Hnew = 0.5 * (Hnew + Hnew.T)
    # the prior mean: the minimizer of the marginal quadratic around the
    # current estimates of the new anchor cameras
    P = 6 * na
    xi0 = -torch.linalg.solve(Hnew + eps * torch.eye(P, dtype=dtype,
                                                     device=device), gnew)
    return (WindowPrior(H=Hnew, xi0=xi0, anchor_R=poses.R[n_drop:inv],
                        anchor_t=poses.t[n_drop:inv]),
            np.flatnonzero(use_track))


class _HostObs(NamedTuple):
    cam_idx: np.ndarray
    lm_idx: np.ndarray
    uv: np.ndarray
    weight: np.ndarray


def run_sliding_window(obs, poses_init, points_init, *, window=24, shift=12,
                       na=8, max_iters=15, fix_first=True):
    """Sweep the trajectory in overlapping windows, each solved with the
    marginalization prior, the dropped cameras folded into the next prior.
    obs: the whole problem's BAObservations; poses_init, points_init: the
    initial values (a camera's or landmark's until it enters a window).
    Runs on the device of points_init. Returns (poses SE3 (C), points
    (L, 3), a list of {"w0", "cost", "it", "n_obs", "cost0"}, one a window,
    cost0 the window's cost at its start)."""
    cam = obs.cam_idx.cpu().numpy()
    lm = obs.lm_idx.cpu().numpy()
    w_np = obs.weight.cpu().numpy()
    uv_np = obs.uv.cpu().numpy()
    C = poses_init.t.shape[0]
    L = points_init.shape[0]
    dtype, device = points_init.dtype, points_init.device
    if not (0 < shift <= window <= C):
        raise ValueError(f"need 0 < shift <= window <= C, got "
                         f"shift={shift}, window={window}, C={C}")
    if not (0 < na <= window - shift or window >= C):
        raise ValueError(f"need na <= window - shift (anchors must survive "
                         f"the shift), got na={na}, window={window}, "
                         f"shift={shift}")
    if shift < na and window < C:
        raise ValueError(f"need shift >= na (old anchors must be inside the "
                         f"dropped span at marginalization), got "
                         f"shift={shift}, na={na}")

    est_R = poses_init.R.clone()
    est_t = poses_init.t.clone()
    est_p = points_init.clone()
    consumed = np.zeros(L, bool)
    starts = list(range(0, max(C - window, 0) + 1, shift))
    if starts[-1] != C - window:
        starts.append(max(C - window, 0))

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    diagnostics = []
    prior = empty_prior(na, device=device)
    for wi, w0 in enumerate(starts):
        sel = np.flatnonzero((w_np > 0) & (cam >= w0) & (cam < w0 + window)
                             & ~consumed[lm])
        lms = np.unique(lm[sel])
        lmap = np.zeros(L, np.int64)
        lmap[lms] = np.arange(lms.size)
        Lw = max(int(lms.size), 1)
        np_dtype = uv_np.dtype
        obs_w = BAObservations(
            cam_idx=t((cam[sel] - w0).astype(np.int32)),
            lm_idx=t(lmap[lm[sel]].astype(np.int32)),
            uv=t(uv_np[sel]), weight=t(w_np[sel].astype(np_dtype)))
        work = build_flat_work(obs_w, window, Lw, dtype=dtype,
                               use_cam_table=False)
        poses0 = se3.SE3(est_R[w0:w0 + window], est_t[w0:w0 + window])
        lms_t = t(lms.astype(np.int64))
        points0 = (est_p[lms_t] if lms.size
                   else torch.zeros((1, 3), dtype=dtype, device=device))
        fixed = torch.zeros(window, dtype=torch.bool, device=device)
        if wi == 0 and fix_first:
            fixed[0] = True

        costs = []
        out = solve_window(poses0, points0, obs_w, work, prior,
                           fixed_mask=fixed, max_iters=max_iters, costs=costs)
        est_R[w0:w0 + window] = out.poses.R
        est_t[w0:w0 + window] = out.poses.t
        if lms.size:
            est_p[lms_t] = out.points
        diagnostics.append({"w0": w0, "cost": float(out.cost), "it": out.it,
                            "n_obs": int(sel.size),
                            "cost0": float(costs[0])})

        if w0 + window >= C:
            break
        n_drop = min(starts[wi + 1], C - window) - w0
        if n_drop <= 0:
            continue
        # marginalize in window-local indices, on the not yet consumed
        sub = np.flatnonzero((w_np > 0) & ~consumed[lm]
                             & (cam >= w0) & (cam < w0 + window))
        obs_m = _HostObs(cam_idx=(cam[sub] - w0).astype(np.int32),
                         lm_idx=lm[sub].astype(np.int32), uv=uv_np[sub],
                         weight=w_np[sub])
        prior, used = marginalize(out.poses, est_p, obs_m, prior,
                                  n_drop=n_drop, na=na,
                                  fixed_mask=fixed if wi == 0 else None)
        consumed[used] = True
    return se3.SE3(est_R, est_t), est_p, diagnostics
