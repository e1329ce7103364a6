"""On-manifold IMU preintegration (Forster-style), port of
``slam_tricks_tpu/estimation/preintegration.py``.

Preintegrated deltas between keyframes i and j from raw gyro / accel
samples:

    dR_{k+1} = dR_k Exp((w_k - bg) dt)
    dv_{k+1} = dv_k + dRm_k (a_k - ba) dt
    dp_{k+1} = dp_k + dv_k dt + 1/2 dRm_k (a_k - ba) dt^2

with dRm_k = dR_k Exp((w_k - bg) dt / 2) the midpoint rotation (a
second-order integrator), first-order bias Jacobians (d*/dbg, d*/dba) and a
9x9 tangent covariance ([phi, v, p] ordering) propagated alongside.

``preintegrate`` takes any leading batch of segments, gyro and accel
(..., S, 3): the JAX package's S-step ``lax.scan`` (batched over segments
with ``vmap``) is a loop over the S samples on batched tensors here, one
set of batched operations a sample for all segments at once.

Conventions (as the JAX package's):
- the IMU measures w_meas = w_body + bg + n_g and
  a_meas = R^T (a_world - g) + ba + n_a, gravity g pointing down;
- ``sigma_g`` / ``sigma_a`` are continuous-time noise densities; the
  discrete per-sample covariance is sigma^2 / dt;
- ``imu_residual`` is the 9-vector
    r_R = Log((dR Exp(dRg dbg))^T R_i^T R_j)
    r_v = R_i^T (v_j - v_i - g Dt) - (dv + dvg dbg + dva dba)
    r_p = R_i^T (p_j - p_i - v_i Dt - g Dt^2 / 2) - (dp + dpg dbg + dpa dba)
  and ``whiten`` multiplies it by L^-1, cov = L Lᵀ.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import so3

GRAVITY = (0.0, 0.0, -9.81)


class PreintegratedImu(NamedTuple):
    """Preintegrated IMU segments, every field with the segments' leading
    batch dims (...)."""
    dR: torch.Tensor    # (..., 3, 3) rotation delta
    dv: torch.Tensor    # (..., 3) velocity delta (body-i frame)
    dp: torch.Tensor    # (..., 3) position delta (body-i frame)
    cov: torch.Tensor   # (..., 9, 9) tangent covariance, [phi, v, p]
    dRg: torch.Tensor   # (..., 3, 3) d Log(dR) / d bg
    dvg: torch.Tensor   # (..., 3, 3) d dv / d bg
    dva: torch.Tensor   # (..., 3, 3) d dv / d ba
    dpg: torch.Tensor   # (..., 3, 3) d dp / d bg
    dpa: torch.Tensor   # (..., 3, 3) d dp / d ba
    dt: torch.Tensor    # (...) total segment duration
    bg0: torch.Tensor   # (..., 3) gyro bias the segment was integrated at
    ba0: torch.Tensor   # (..., 3) accel bias the segment was integrated at


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def preintegrate(gyro, accel, dt, bg, ba, sigma_g=1.7e-4, sigma_a=2e-3,
                 init_cov_eps=1e-16):
    """Integrate S samples of every segment into a batched PreintegratedImu.

    gyro, accel: (..., S, 3) raw measurements (gyro a tensor; its dtype and
    device are the result's); dt: a scalar, (S,) or (..., S) sample
    periods; bg, ba: (3,) or (..., 3) biases to integrate at;
    sigma_g / sigma_a: continuous noise densities."""
    dtype, device = gyro.dtype, gyro.device
    accel = torch.as_tensor(accel, dtype=dtype, device=device)
    batch, S = gyro.shape[:-2], gyro.shape[-2]
    dts = torch.broadcast_to(torch.as_tensor(dt, dtype=dtype, device=device),
                             (*batch, S))
    bg = torch.broadcast_to(torch.as_tensor(bg, dtype=dtype, device=device),
                            (*batch, 3))
    ba = torch.broadcast_to(torch.as_tensor(ba, dtype=dtype, device=device),
                            (*batch, 3))
    sg = torch.tensor(sigma_g, dtype=dtype, device=device) ** 2
    sa = torch.tensor(sigma_a, dtype=dtype, device=device) ** 2
    I3 = torch.eye(3, dtype=dtype, device=device)
    Z3 = torch.zeros((*batch, 3, 3), dtype=dtype, device=device)

    dR = I3.expand(*batch, 3, 3)
    dv = torch.zeros((*batch, 3), dtype=dtype, device=device)
    dp = dv
    cov = (torch.eye(9, dtype=dtype, device=device)
           * torch.tensor(init_cov_eps, dtype=dtype, device=device)
           ).expand(*batch, 9, 9)
    dRg = dvg = dva = dpg = dpa = Z3
    T = torch.zeros(batch, dtype=dtype, device=device)
    A = torch.zeros((*batch, 9, 9), dtype=dtype, device=device)
    A[..., 3:6, 3:6] = I3
    A[..., 6:9, 6:9] = I3
    B = torch.zeros((*batch, 9, 6), dtype=dtype, device=device)
    for k in range(S):
        h = dts[..., k]
        hv, hm = h[..., None], h[..., None, None]
        w = gyro[..., k, :] - bg
        a = accel[..., k, :] - ba
        wh = w * hv
        inc = so3.exp(wh)                    # Exp((w - bg) dt)
        Jr = so3.jr(wh)
        inc_h = so3.exp(0.5 * wh)            # the midpoint rotation
        dRm = dR @ inc_h
        dRa = dRm @ so3.hat(a)
        # bias sensitivity of the midpoint rotation
        dRgm = inc_h.mT @ dRg - so3.jr(0.5 * wh) * (0.5 * hm)

        # cov <- A cov Aᵀ + B diag(sg2 / h, sa2 / h) Bᵀ (A and B are
        # written in place: their constant blocks were set once)
        A[..., 0:3, 0:3] = inc.mT
        A[..., 3:6, 0:3] = -dRa * hm
        A[..., 6:9, 0:3] = -0.5 * dRa * hm * hm
        A[..., 6:9, 3:6] = I3 * hm
        B[..., 0:3, 0:3] = Jr * hm
        B[..., 3:6, 3:6] = dRm * hm
        B[..., 6:9, 3:6] = 0.5 * dRm * hm * hm
        noise = torch.cat([(sg / h)[..., None].expand(*batch, 3),
                           (sa / h)[..., None].expand(*batch, 3)], dim=-1)
        cov = A @ cov @ A.mT + (B * noise[..., None, :]) @ B.mT

        # bias Jacobians, before the state (they use the k-step dR)
        dRa_g = dRa @ dRgm
        dpg = dpg + dvg * hm - 0.5 * dRa_g * hm * hm
        dpa = dpa + dva * hm - 0.5 * dRm * hm * hm
        dvg = dvg - dRa_g * hm
        dva = dva - dRm * hm
        dRg = inc.mT @ dRg - Jr * hm

        # state
        dRm_a = _matvec(dRm, a)
        dp = dp + dv * hv + 0.5 * dRm_a * hv * hv
        dv = dv + dRm_a * hv
        dR = dR @ inc
        T = T + h
    return PreintegratedImu(dR, dv, dp, cov, dRg, dvg, dva, dpg, dpa, T,
                            bg0=bg, ba0=ba)


def bias_corrected(pre: PreintegratedImu, bg, ba):
    """First-order corrected deltas (dR, dv, dp) at biases (bg, ba) !=
    (bg0, ba0); bg, ba broadcast against the segments' batch."""
    dbg = bg - pre.bg0
    dba = ba - pre.ba0
    dR = pre.dR @ so3.exp(_matvec(pre.dRg, dbg))
    dv = pre.dv + _matvec(pre.dvg, dbg) + _matvec(pre.dva, dba)
    dp = pre.dp + _matvec(pre.dpg, dbg) + _matvec(pre.dpa, dba)
    return dR, dv, dp


def imu_residual(pre: PreintegratedImu, Ri, vi, Tj, vj, bg, ba,
                 gravity=GRAVITY):
    """Raw (unwhitened) 9-vector residuals (..., 9) between states
    (Ri, vi) and (Tj, vj) (``se3.SE3`` poses and (..., 3) velocities, with
    the segments' batch) at biases (bg, ba)."""
    dtype = pre.dv.dtype
    g = torch.as_tensor(gravity, dtype=dtype, device=pre.dv.device)
    Dt = pre.dt[..., None]
    dRc, dvc, dpc = bias_corrected(pre, bg, ba)
    RiT = Ri.R.mT
    r_R = so3.log(dRc.mT @ (RiT @ Tj.R))
    r_v = _matvec(RiT, vj - vi - g * Dt) - dvc
    r_p = _matvec(RiT, Tj.t - Ri.t - vi * Dt - 0.5 * g * Dt * Dt) - dpc
    return torch.cat([r_R, r_v, r_p], dim=-1)


def _cov_factor(pre: PreintegratedImu, dtype, jitter):
    cov = pre.cov.to(dtype) + (torch.eye(9, dtype=dtype, device=pre.cov.device)
                               * jitter)
    return torch.linalg.cholesky(cov)


def whiten(pre: PreintegratedImu, r, jitter=1e-12):
    """Whiten residuals r (..., 9) by the segments' covariance: L^-1 r with
    cov + jitter I = L Lᵀ (the Ceres ``sqrt_information * residual``
    role)."""
    L = _cov_factor(pre, r.dtype, jitter)
    return torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]


def whitener(pre: PreintegratedImu, dtype, jitter=1e-12):
    """L^-1 (..., 9, 9) of ``whiten``, once for all states: the covariance
    does not depend on them, so the smoothers whiten by this product where
    the JAX package solves with L at every evaluation (the same to
    rounding)."""
    L = _cov_factor(pre, dtype, jitter)
    eye = torch.eye(9, dtype=dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)
