"""Closed-form visual-inertial initialization (port of
``slam_tricks_tpu/estimation/vi_init.py``): metric scale, gravity and
keyframe velocities from an up-to-scale visual trajectory and preintegrated
IMU segments.

The preintegration constraints

    R_k^T (v_{k+1} - v_k - g Dt_k)                       = dv_k
    R_k^T (s p_{k+1} - s p_k - v_k Dt_k - 1/2 g Dt_k^2)  = dp_k

are linear in x = [s, g (3), v_0 .. v_{K-1}]: one dense least-squares
solve (6 (K-1) equations, 3K + 4 unknowns), then optionally a second one
with |g| fixed (2-DoF gravity refinement on its tangent plane).

The system is built by plain indexing (the JAX package's one-hot build is
a TPU layout; the entries are the same). Both solves are
``torch.linalg.lstsq(..., driver="gels")``: QR with full rank assumed, the
only LAPACK routine of ``lstsq`` that CUDA has, taken on the CPU as well.
A has full column rank for K >= 4, which ``vi_initialize`` enforces.
"""

from typing import NamedTuple

import torch


class ViInit(NamedTuple):
    scale: torch.Tensor     # ()
    gravity: torch.Tensor   # (3,) world frame
    vels: torch.Tensor      # (K, 3) world frame
    residual: torch.Tensor  # () rms of the linear system at the solution


def _build_system(pre_batch, poses_visual):
    """A (6 (K-1), 4 + 3K), b (6 (K-1),): a segment's dv rows, then its dp
    rows."""
    K = poses_visual.t.shape[0]
    dtype, device = poses_visual.t.dtype, poses_visual.t.device
    n = K - 1
    RkT = poses_visual.R[:-1].mT
    Dt = pre_batch.dt[:, None, None]
    dp_vis = poses_visual.t[1:] - poses_visual.t[:-1]
    A = torch.zeros((n, 6, 4 + 3 * K), dtype=dtype, device=device)
    V = A[:, :, 4:].view(n, 6, K, 3)      # the velocity columns
    k = torch.arange(n, device=device)
    A[:, 0:3, 1:4] = -RkT * Dt
    V[k, 0:3, k] = -RkT
    V[k, 0:3, k + 1] = RkT
    A[:, 3:6, 0] = (RkT @ dp_vis[..., None])[..., 0]
    A[:, 3:6, 1:4] = -0.5 * RkT * Dt * Dt
    V[k, 3:6, k] = -RkT * Dt
    b = torch.cat([pre_batch.dv, pre_batch.dp], dim=-1)
    return A.reshape(-1, 4 + 3 * K), b.reshape(-1)


def _lstsq(A, b):
    return torch.linalg.lstsq(A, b[:, None], driver="gels").solution[:, 0]


def vi_initialize(pre_batch, poses_visual, gravity_norm=9.81,
                  refine_gravity=True):
    """Recover (scale, gravity, velocities) from K up-to-scale visual poses
    (``se3.SE3`` (K,), metric rotations, translations off by one global
    scale) and K-1 preintegrated segments (integrated at a fixed bias).
    Returns ViInit; apply with t_metric = init.scale * poses_visual.t."""
    K = poses_visual.t.shape[0]
    if K < 4:
        # 6(K-1) equations vs 3K+4 unknowns: determined only for K >= 4
        raise ValueError(f"vi_initialize needs >= 4 keyframes, got K={K} "
                         "(scale+gravity+velocities underdetermined: "
                         f"{6*(K-1)} equations, {3*K+4} unknowns)")
    A, b = _build_system(pre_batch, poses_visual)
    x = _lstsq(A, b)
    s, g, v = x[0], x[1:4], x[4:].reshape(-1, 3)

    if refine_gravity:
        # g = gn (ghat + B dxy), B spanning the sphere's tangent plane at
        # ghat: one more solve on the reduced unknowns [s, dxy, v]
        dtype, device = b.dtype, b.device
        gn = torch.tensor(gravity_norm, dtype=dtype, device=device)
        ghat = g / torch.clamp_min(torch.linalg.vector_norm(g), 1e-12)
        ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=device)
        ey = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device)
        ref = torch.where(ghat[0].abs() < 0.9, ex, ey)
        b1 = torch.linalg.cross(ghat, ref)
        b1 = b1 / torch.linalg.vector_norm(b1)
        b2 = torch.linalg.cross(ghat, b1)
        B = torch.stack([b1, b2], dim=1)              # (3, 2)
        Ag = A[:, 1:4]
        A_red = torch.cat([A[:, :1], Ag @ B, A[:, 4:]], dim=1)
        b_red = b - Ag @ (gn * ghat)
        x2 = _lstsq(A_red, b_red)
        s = x2[0]
        g = gn * ghat + B @ x2[1:3]
        # back onto the sphere (the tangent step can leave it slightly)
        g = gn * g / torch.clamp_min(torch.linalg.vector_norm(g), 1e-12)
        v = x2[3:].reshape(-1, 3)

    res = torch.sqrt(torch.mean((A @ torch.cat([s[None], g, v.reshape(-1)])
                                 - b) ** 2))
    return ViInit(scale=s, gravity=g, vels=v, residual=res)
