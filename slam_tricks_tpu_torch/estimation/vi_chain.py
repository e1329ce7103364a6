"""Chain visual-inertial smoother at scale (port of
``slam_tricks_tpu/estimation/vi_chain.py``): block-tridiagonal LM over
(pose, velocity) keyframe states with a shared-bias Schur complement.

- An IMU factor touches states k and k+1 and the shared bias, so the state
  Hessian is SPD block-tridiagonal with 9-dim blocks ([omega, dt, dv]
  tangent a keyframe), solved by ``ops.tridiag_solve`` (block cyclic
  reduction, the CUDA kernel on the card) through
  ``banded_flat.block_tridiag_solve``;
- the shared bias couples to every state (a bordered system); it is
  eliminated by a 6-dim Schur complement: one multi-right-hand-side solve
  of [-g | U] (q = 7 columns) an iteration, then a 6x6 solve.

The factors' Jacobians are analytic (the JAX package takes ``jacfwd`` of
each 9-row factor over its 24 tangent columns): with E = dRcᵀ R_iᵀ R_j,
r_R = Log(E) and Jr^-1 = Jr^-1(r_R),

    d r_R / d omega_j = Jr^-1,
    d r_R / d omega_i = -Jr^-1 R_jᵀ R_i,
    d r_R / d bg      = -Jr^-1 Eᵀ Jr(dRg dbg) dRg,
    d r_v / d omega_i = [R_iᵀ (v_j - v_i - g Dt)]x,
    d r_p / d omega_i = [R_iᵀ (p_j - p_i - v_i Dt - g Dt^2 / 2)]x,

the velocity and position columns ±R_iᵀ (and -R_iᵀ Dt for r_p by v_i),
the bias columns minus the preintegration's bias Jacobians; the pose
observation's rotation rows are Jr^-1(Log(R_obsᵀ R)) w_rot. Each factor is
whitened by its segment's L^-1, formed once a solve.

The LM loop runs on the host with one sync a step; a rejected step reuses
the carried linearization, and the predicted reduction is built from
lam * dscale (not from the damped diagonal), as in the JAX package.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.estimation import preintegration as pim
from slam_tricks_tpu_torch.manifolds import se3, so3
from slam_tricks_tpu_torch.solvers.banded_flat import (
    _takahashi_inverse_blocks, block_tridiag_solve)


class ViChainState(NamedTuple):
    poses: se3.SE3        # (K,)
    vels: torch.Tensor    # (K, 3)
    bias: torch.Tensor    # (6,)
    cost: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    it: int
    done: bool
    lin: tuple            # (D, E, U, Hbb, g, gb) at the current state


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def _retract_states(poses, vels, dx):
    """dx: (K, 9) tangent [omega, dt, dv]."""
    return (se3.SE3(poses.R @ so3.exp(dx[:, 0:3]), poses.t + dx[:, 3:6]),
            vels + dx[:, 6:9])


def _make_system(pre_batch, obs_poses, w_rot, w_tr, w_b, bias_anchor,
                 gravity, K, dtype):
    """The chain VI system's linearizer and cost (the solver's and
    ``vi_chain_covariances``'). Returns (linearize(poses, vels, bias) ->
    (D (K, 9, 9), E (K-1, 9, 9), U (K, 9, 6), Hbb (6, 6), g (K, 9),
    gb (6,)), total_cost(poses, vels, bias))."""
    pre = pre_batch
    device = obs_poses.t.device
    g_vec = torch.as_tensor(gravity, dtype=dtype, device=device)
    Linv = pim.whitener(pre, dtype)
    Dt = pre.dt[:, None]
    I3 = torch.eye(3, dtype=dtype, device=device)
    eye6 = torch.eye(6, dtype=dtype, device=device)

    def imu_terms(poses, vels, bias):
        """The raw residual pieces a factor: (r (K-1, 9) unwhitened, E,
        R_iᵀ, R_iᵀ y_v, R_iᵀ y_p, dRg dbg)."""
        dbg = bias[:3] - pre.bg0
        dba = bias[3:] - pre.ba0
        phi = _matvec(pre.dRg, dbg)
        dRc = pre.dR @ so3.exp(phi)
        dvc = pre.dv + _matvec(pre.dvg, dbg) + _matvec(pre.dva, dba)
        dpc = pre.dp + _matvec(pre.dpg, dbg) + _matvec(pre.dpa, dba)
        Ri, Rj = poses.R[:-1], poses.R[1:]
        RiT = Ri.mT
        E_ = dRc.mT @ (RiT @ Rj)
        vi, vj = vels[:-1], vels[1:]
        yv = _matvec(RiT, vels[1:] - vi - g_vec * Dt)
        yp = _matvec(RiT, poses.t[1:] - poses.t[:-1] - vi * Dt
                     - 0.5 * g_vec * Dt * Dt)
        r = torch.cat([so3.log(E_), yv - dvc, yp - dpc], dim=-1)
        return r, E_, RiT, Rj, yv, yp, phi

    def obs_residual(poses):
        r_rot = so3.local(obs_poses.R, poses.R)
        return r_rot, torch.cat([r_rot * w_rot,
                                 (poses.t - obs_poses.t) * w_tr], dim=-1)

    def linearize(poses, vels, bias):
        r, E_, RiT, Rj, yv, yp, phi = imu_terms(poses, vels, bias)
        n = r.shape[0]
        Jrinv = so3.jr_inv(r[:, 0:3])
        Ji = r.new_zeros((n, 9, 9))
        Jj = r.new_zeros((n, 9, 9))
        Jb = r.new_zeros((n, 9, 6))
        Ji[:, 0:3, 0:3] = -Jrinv @ (Rj.mT @ RiT.mT)
        Ji[:, 3:6, 0:3] = so3.hat(yv)
        Ji[:, 3:6, 6:9] = -RiT
        Ji[:, 6:9, 0:3] = so3.hat(yp)
        Ji[:, 6:9, 3:6] = -RiT
        Ji[:, 6:9, 6:9] = -RiT * Dt[..., None]
        Jj[:, 0:3, 0:3] = Jrinv
        Jj[:, 3:6, 6:9] = RiT
        Jj[:, 6:9, 3:6] = RiT
        Jb[:, 0:3, 0:3] = -Jrinv @ E_.mT @ so3.jr(phi) @ pre.dRg
        Jb[:, 3:6, 0:3] = -pre.dvg
        Jb[:, 3:6, 3:6] = -pre.dva
        Jb[:, 6:9, 0:3] = -pre.dpg
        Jb[:, 6:9, 3:6] = -pre.dpa
        r_i = _matvec(Linv, r)
        Ji, Jj, Jb = Linv @ Ji, Linv @ Jj, Linv @ Jb

        r_rot, r_o = obs_residual(poses)
        Jo = r.new_zeros((K, 6, 9))
        Jo[:, 0:3, 0:3] = so3.jr_inv(r_rot) * w_rot
        Jo[:, 3:6, 3:6] = I3 * w_tr

        # the block-tridiagonal states and the bias border
        D = r.new_zeros((K, 9, 9))
        D[:-1] += Ji.mT @ Ji
        D[1:] += Jj.mT @ Jj
        D = D + Jo.mT @ Jo
        E = Jj.mT @ Ji                     # T[k+1, k] = Jjᵀ Ji
        U = r.new_zeros((K, 9, 6))
        U[:-1] += Ji.mT @ Jb
        U[1:] += Jj.mT @ Jb
        Jb2 = Jb.reshape(-1, 6)
        Hbb = Jb2.mT @ Jb2 + eye6 * w_b * w_b
        g = r.new_zeros((K, 9))
        g[:-1] += _matvec(Ji.mT, r_i)
        g[1:] += _matvec(Jj.mT, r_i)
        g = g + _matvec(Jo.mT, r_o)
        gb = Jb2.mT @ r_i.reshape(-1) + w_b * w_b * (bias - bias_anchor)
        return D, E, U, Hbb, g, gb

    def total_cost(poses, vels, bias):
        r_i = _matvec(Linv, imu_terms(poses, vels, bias)[0])
        r_o = obs_residual(poses)[1]
        r_b = w_b * (bias - bias_anchor)
        return 0.5 * (torch.sum(r_i * r_i) + torch.sum(r_o * r_o)
                      + torch.sum(r_b * r_b))

    return linearize, total_cost


def _system(pre_batch, obs_poses, obs_rot_sigma, obs_trans_sigma,
            bias_prior_sigma, gravity, name):
    K = obs_poses.t.shape[0]
    if K < 2:
        raise ValueError(f"{name} needs >= 2 keyframes, got K={K} (no IMU "
                         "segment to constrain)")
    dtype, device = obs_poses.t.dtype, obs_poses.t.device
    T_ = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    bias_anchor = torch.cat([pre_batch.bg0[0], pre_batch.ba0[0]])
    return _make_system(pre_batch, obs_poses, T_(1.0 / obs_rot_sigma),
                        T_(1.0 / obs_trans_sigma),
                        T_(1.0 / bias_prior_sigma), bias_anchor, gravity, K,
                        dtype)


def solve_vi_chain(pre_batch, obs_poses, poses0, vels0, bias0, *,
                   obs_rot_sigma=0.01, obs_trans_sigma=0.02,
                   bias_prior_sigma=1.0, gravity=pim.GRAVITY,
                   max_iters=30, lambda_init=1e-4, xtol=1e-12, costs=None):
    """MAP smoothing over (poses, velocities, shared bias) with chain
    factors, O(K) memory: the problem and optimum of
    ``vi_smoother.solve_vi_smoother``, for large K. If `costs` is a list,
    the cost at the start and after each step is appended (device
    scalars). Returns the final ViChainState."""
    dtype, device = obs_poses.t.dtype, obs_poses.t.device
    linearize, total_cost = _system(pre_batch, obs_poses, obs_rot_sigma,
                                    obs_trans_sigma, bias_prior_sigma,
                                    gravity, "solve_vi_chain")
    poses, vels, bias = poses0, vels0.to(dtype), bias0.to(dtype)
    cost = total_cost(poses, vels, bias)
    lin = linearize(poses, vels, bias)
    lam = torch.tensor(lambda_init, dtype=dtype, device=device)
    nu = torch.tensor(2.0, dtype=dtype, device=device)
    it, done = 0, False
    if costs is not None:
        costs.append(cost)
    while not done and it < max_iters:
        D, E, U, Hbb, g, gb = lin
        # Marquardt scaling on the diagonal
        dscale = torch.clamp_min(torch.diagonal(D, dim1=-2, dim2=-1), 1e-12)
        Dd = D + lam * torch.diag_embed(dscale)
        bscale = torch.clamp_min(torch.diagonal(Hbb), 1e-12)
        Hbb_d = Hbb + lam * torch.diag(bscale)

        # Schur on the bias: one multi-RHS solve of [-g | U]
        sol = block_tridiag_solve(Dd, E, torch.cat([-g[..., None], U], -1))
        y, Z = sol[..., 0], sol[..., 1:]
        U2 = U.reshape(-1, 6)
        cap = Hbb_d - U2.mT @ Z.reshape(-1, 6)
        rhs_b = -gb - U2.mT @ y.reshape(-1)
        db = torch.linalg.solve_ex(cap, rhs_b)[0]
        dx = y - _matvec(Z, db)
        poses_new, vels_new = _retract_states(poses, vels, dx)
        bias_new = bias + db
        cost_new = total_cost(poses_new, vels_new, bias_new)

        # gain ratio on the damped model's predicted reduction
        pred = 0.5 * (torch.sum(dx * (lam * dscale * dx - g))
                      + torch.sum(db * (lam * bscale * db - gb)))
        rho = (cost - cost_new) / torch.clamp_min(pred, 1e-30)
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        lam_acc = lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3,
                                        1.0 / 3.0)
        lam = torch.where(accept, lam_acc, lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        step = torch.sqrt(torch.sum(dx * dx) + torch.sum(db * db))
        accepted, done = torch.stack([accept, accept & (step < xtol)]).tolist()
        if accepted:   # a rejected step keeps the state and its linearization
            poses, vels, bias, cost = poses_new, vels_new, bias_new, cost_new
            lin = linearize(poses, vels, bias)
        it += 1
        if costs is not None:
            costs.append(cost)
    return ViChainState(poses, vels, bias, cost, lam, nu, it, done, lin)


def vi_chain_covariances(pre_batch, obs_poses, poses, vels, bias, *,
                         obs_rot_sigma=0.01, obs_trans_sigma=0.02,
                         bias_prior_sigma=1.0, gravity=pim.GRAVITY):
    """Posterior marginal covariances at the smoother's solution: (state_cov
    (K, 9, 9) in the [omega, dt, dv] tangent, bias_cov (6, 6)). With the
    bordered Hessian H = [[T, U], [Uᵀ, Hbb]] (T block-tridiagonal),

        state_cov_k = Takahashi_diag(T)_k + Z_k cap^-1 Z_kᵀ,
        Z = T^-1 U (one multi-RHS solve, q = 6), cap = Hbb - Uᵀ Z,
        bias_cov = cap^-1.

    Only the block diagonal of T^-1 is formed (the two-sweep Takahashi
    recursion of ``banded_flat``, a loop over the K blocks)."""
    dtype = obs_poses.t.dtype
    linearize, _ = _system(pre_batch, obs_poses, obs_rot_sigma,
                           obs_trans_sigma, bias_prior_sigma, gravity,
                           "vi_chain_covariances")
    D, E, U, Hbb, _, _ = linearize(poses, vels.to(dtype), bias.to(dtype))
    P, _ = _takahashi_inverse_blocks(D, E, D.shape[0])    # diag of T^-1
    Z = block_tridiag_solve(D, E, U)                      # (K, 9, 6)
    cap = Hbb - U.reshape(-1, 6).mT @ Z.reshape(-1, 6)
    bias_cov = torch.linalg.inv_ex(cap)[0]
    state_cov = P + Z @ bias_cov @ Z.mT
    return state_cov, bias_cov
