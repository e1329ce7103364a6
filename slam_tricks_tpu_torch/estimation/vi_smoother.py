"""Inertial smoothing MAP backend, port of
``slam_tricks_tpu/estimation/vi_smoother.py``: keyframe states optimized
over preintegrated IMU factors and pose observations, as one dense LM solve
(``solvers/lm.py``) over the product manifold (SO(3) + R^3)^K x R^{3K}
(velocities) x R^6 (shared biases); and visual-inertial bundle adjustment,
the same with monocular reprojection factors and the landmarks.

All K-1 segments integrate at once (``preintegration.preintegrate`` on the
(K-1, S, 3) streams) and every factor evaluates as one batched residual
stack. The segments' whitening L^-1 is formed once a solve
(``preintegration.whitener``), not at every residual evaluation: the
covariance does not depend on the state. For long trajectories
``vi_chain.solve_vi_chain`` solves the same problem; this module is the
dense formulation it is held against.

The simulators draw their noise from ``np.random.default_rng(seed)`` in
the JAX package's order, so a seed gives the same noise; the closed-form
trajectory is computed in torch, whose float32 rounding differs from
XLA's (the float64 trajectories agree to rounding).
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.estimation import preintegration as pim
from slam_tricks_tpu_torch.manifolds import manifold as man
from slam_tricks_tpu_torch.manifolds import se3, so3
from slam_tricks_tpu_torch.solvers.lm import levenberg_marquardt


class ViSimData(NamedTuple):
    poses_true: se3.SE3      # (K,) keyframe poses
    vels_true: torch.Tensor  # (K, 3)
    gyro: torch.Tensor       # (K-1, S, 3) raw samples per segment
    accel: torch.Tensor      # (K-1, S, 3)
    dt: float                # sample period
    obs_poses: se3.SE3       # (K,) noisy pose observations
    bg_true: torch.Tensor    # (3,)
    ba_true: torch.Tensor    # (3,)


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def simulate_vi(n_keyframes=24, samples_per_seg=20, dt=0.005,
                omega_body=(0.15, -0.1, 0.6), radius=2.0, climb=0.3,
                turn_rate=0.9, sigma_g=0.0, sigma_a=0.0,
                bg=(0.02, -0.015, 0.01), ba=(0.08, -0.05, 0.12),
                obs_rot_noise=0.01, obs_trans_noise=0.02, seed=0,
                dtype=torch.float64, device=None):
    """Analytic trajectory with exactly known IMU: constant body angular
    velocity (R(t) = Exp(w0 t)) and a circular climb
    p(t) = r [cos, sin, 0] + [0, 0, c t]; gyro and accel follow in closed
    form, sampled at the midpoint of each interval. Noise: gyro and accel
    (if sigma > 0), then the pose observations, from one numpy generator.
    On `device`, the card unless the caller names another."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    T_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    w0 = T_(omega_body)
    g = T_(pim.GRAVITY)
    K, S = n_keyframes, samples_per_seg

    def p_of(t):
        ang = turn_rate * t
        return torch.stack([radius * torch.cos(ang), radius * torch.sin(ang),
                            climb * t], dim=-1)

    def v_of(t):
        ang = turn_rate * t
        return torch.stack([-radius * turn_rate * torch.sin(ang),
                            radius * turn_rate * torch.cos(ang),
                            torch.full_like(t, climb)], dim=-1)

    def a_world_of(t):
        ang = turn_rate * t
        return torch.stack([-radius * turn_rate ** 2 * torch.cos(ang),
                            -radius * turn_rate ** 2 * torch.sin(ang),
                            torch.zeros_like(t)], dim=-1)

    t_kf = torch.arange(K, dtype=dtype, device=device) * (S * dt)
    poses_true = se3.SE3(so3.exp(w0 * t_kf[:, None]), p_of(t_kf))
    vels_true = v_of(t_kf)

    t_s = (torch.arange(K - 1, dtype=dtype, device=device)[:, None] * S
           + torch.arange(S, dtype=dtype, device=device)[None, :] + 0.5) * dt
    bg_t, ba_t = T_(bg), T_(ba)
    R_s = so3.exp(w0 * t_s[..., None])
    gyro = (w0 + bg_t).expand(K - 1, S, 3)
    accel = _matvec(R_s.mT, a_world_of(t_s) - g) + ba_t
    if sigma_g > 0:
        gyro = gyro + T_(rng.normal(0, sigma_g / np.sqrt(dt), gyro.shape))
    if sigma_a > 0:
        accel = accel + T_(rng.normal(0, sigma_a / np.sqrt(dt), accel.shape))

    # noisy pose observations (the st4 observation model)
    dR = T_(rng.normal(0, obs_rot_noise, (K, 3)))
    dp = T_(rng.normal(0, obs_trans_noise, (K, 3)))
    obs_poses = se3.SE3(poses_true.R @ so3.exp(dR), poses_true.t + dp)
    return ViSimData(poses_true, vels_true, gyro.contiguous(), accel, dt,
                     obs_poses, bg_t, ba_t)


def preintegrate_segments(sim: ViSimData, bg, ba, sigma_g=1.7e-4,
                          sigma_a=2e-3):
    """All K-1 segments at once -> batched PreintegratedImu (K-1,)."""
    return pim.preintegrate(sim.gyro, sim.accel, sim.dt, bg, ba,
                            sigma_g=sigma_g, sigma_a=sigma_a)


class ViSolution(NamedTuple):
    poses: se3.SE3
    vels: torch.Tensor
    bias: torch.Tensor    # (6,) [bg, ba]
    cost: torch.Tensor
    iterations: int


def _imu_factors(pre_batch, gravity):
    """r(poses, vels, bias) -> the whitened IMU residuals (K-1, 9)."""
    Linv = pim.whitener(pre_batch, pre_batch.dv.dtype)

    def factors(poses, vels, bias):
        Ti = se3.SE3(poses.R[:-1], poses.t[:-1])
        Tj = se3.SE3(poses.R[1:], poses.t[1:])
        r = pim.imu_residual(pre_batch, Ti, vels[:-1], Tj, vels[1:],
                             bias[:3], bias[3:], gravity)
        return _matvec(Linv, r)

    return factors


def solve_vi_smoother(pre_batch, obs_poses, poses0, vels0, bias0,
                      obs_rot_sigma=0.01, obs_trans_sigma=0.02,
                      bias_prior_sigma=1.0, gravity=pim.GRAVITY,
                      max_iters=30, lambda_init=1e-4):
    """MAP smoothing over (poses, velocities, shared biases).

    pre_batch: batched PreintegratedImu (K-1,) integrated at the bias in
    its bg0 / ba0 (first-order bias correction handles the offset to the
    current estimate). obs_poses: (K,) noisy SE3 observations. Returns
    ViSolution."""
    K = obs_poses.t.shape[0]
    if K < 2:
        raise ValueError(f"solve_vi_smoother needs >= 2 keyframes, got K={K}")
    dtype = obs_poses.t.dtype
    mani = man.product(man.batched(man.so3_r3(), K),
                       man.euclidean((K, 3)),
                       man.euclidean((6,)))
    w_rot = 1.0 / obs_rot_sigma
    w_tr = 1.0 / obs_trans_sigma
    w_bias = 1.0 / bias_prior_sigma
    imu = _imu_factors(pre_batch, gravity)
    anchor = torch.cat([pre_batch.bg0[0], pre_batch.ba0[0]])

    def residual(x):
        poses, vels, bias = x
        r_imu = imu(poses, vels, bias)
        r_obs = torch.cat([so3.local(obs_poses.R, poses.R) * w_rot,
                           (poses.t - obs_poses.t) * w_tr], dim=-1)
        r_bias = (bias - anchor) * w_bias
        return torch.cat([r_imu.reshape(-1), r_obs.reshape(-1), r_bias])

    x0 = (poses0, vels0.to(dtype), bias0.to(dtype))
    res = levenberg_marquardt(residual, x0, mani, max_iters=max_iters,
                              lambda_init=lambda_init)
    poses, vels, bias = res.x
    return ViSolution(poses, vels, bias, res.cost, res.iterations)


def dead_reckon(pre_batch, T0, v0, bg, ba, gravity=pim.GRAVITY):
    """Forward integration of the preintegrated deltas from the first state,
    the no-smoothing baseline (and the smoother's start): a loop over the
    segments. Returns (poses (K,), vels (K, 3))."""
    g = torch.as_tensor(gravity, dtype=T0.t.dtype, device=T0.t.device)
    dRc, dvc, dpc = pim.bias_corrected(pre_batch, bg, ba)
    R, t, v = T0.R, T0.t, v0
    Rs, ts, vs = [R], [t], [v]
    for k in range(dRc.shape[0]):
        Dt = pre_batch.dt[k]
        t = t + v * Dt + 0.5 * g * Dt * Dt + _matvec(R, dpc[k])
        v = v + g * Dt + _matvec(R, dvc[k])
        R = R @ dRc[k]
        Rs.append(R)
        ts.append(t)
        vs.append(v)
    return se3.SE3(torch.stack(Rs), torch.stack(ts)), torch.stack(vs)


# ---- visual-inertial bundle adjustment: reprojection + IMU factors ----

def _camera_points(poses, points):
    """R_kᵀ (X_l - t_k) for every keyframe k and landmark l: (K, L, 3)."""
    return ((points[None] - poses.t[:, None]) @ poses.R)


def simulate_vi_landmarks(sim: ViSimData, n_landmarks=60, shell_radius=5.0,
                          uv_noise=0.0, max_tan=2.0, seed=0):
    """Landmarks on a shell around the trajectory and their
    normalized-plane observations from every keyframe (camera = body).
    Returns (points (L, 3), uv (K, L, 2), weight (K, L)), weight 0 where
    the landmark is behind the camera or outside the field of view."""
    rng = np.random.default_rng(seed)
    dtype, device = sim.poses_true.t.dtype, sim.poses_true.t.device
    dirs = rng.normal(size=(n_landmarks, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.6 * shell_radius, shell_radius, (n_landmarks, 1))
    center = sim.poses_true.t.cpu().numpy().mean(axis=0)
    points = torch.as_tensor(center + dirs * radii, dtype=dtype, device=device)

    p_cam = _camera_points(sim.poses_true, points)
    z = p_cam[..., 2]
    uv = p_cam[..., :2] / torch.where(z.abs() < 1e-6,
                                      torch.full_like(z, 1e-6), z)[..., None]
    vis = (z > 0.25) & (uv.abs().amax(dim=-1) < max_tan)
    w = vis.to(dtype)
    if uv_noise > 0:
        uv = uv + torch.as_tensor(rng.normal(0, uv_noise, tuple(uv.shape)),
                                  dtype=dtype, device=device)
    return points, uv, w


def solve_vi_ba(pre_batch, uv, weight, poses0, vels0, bias0, points0,
                pose0_prior=None, uv_sigma=1e-3, prior_sigma=1e-4,
                gravity=pim.GRAVITY, max_iters=40, lambda_init=1e-4):
    """Visual-inertial bundle adjustment: monocular reprojection factors
    and preintegrated IMU factors over (poses, velocities, shared biases,
    landmarks). The accelerometer makes metric scale observable; only the
    first pose is held, by a 6-DoF prior (its observation by default).
    uv: (K, L, 2) normalized-plane observations, weight (K, L) (0 = not
    seen). Returns (ViSolution, points)."""
    K = uv.shape[0]
    L = points0.shape[0]
    dtype = uv.dtype
    if pose0_prior is None:
        pose0_prior = se3.SE3(poses0.R[0], poses0.t[0])
    mani = man.product(man.batched(man.so3_r3(), K),
                       man.euclidean((K, 3)),
                       man.euclidean((6,)),
                       man.euclidean((L, 3)))
    w_uv = 1.0 / uv_sigma
    w_prior = 1.0 / prior_sigma
    imu = _imu_factors(pre_batch, gravity)
    w_obs = (weight * w_uv)[..., None]

    def residual(x):
        poses, vels, bias, points = x
        r_imu = imu(poses, vels, bias)
        p_cam = _camera_points(poses, points)
        z = p_cam[..., 2]
        z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        r_uv = (p_cam[..., :2] / z[..., None] - uv) * w_obs
        r_prior = torch.cat([so3.local(pose0_prior.R, poses.R[0]),
                             poses.t[0] - pose0_prior.t]) * w_prior
        return torch.cat([r_imu.reshape(-1), r_uv.reshape(-1), r_prior])

    x0 = (poses0, vels0.to(dtype), bias0.to(dtype), points0.to(dtype))
    res = levenberg_marquardt(residual, x0, mani, max_iters=max_iters,
                              lambda_init=lambda_init)
    poses, vels, bias, points = res.x
    return ViSolution(poses, vels, bias, res.cost, res.iterations), points
