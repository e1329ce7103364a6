"""Multi-view triangulation: N-view DLT and per-landmark Gauss-Newton
refinement (port of ``slam_tricks_tpu/initialization/triangulation.py``;
st20 sim_data.cpp:298-311, st22 two_view_geometry.cpp:103-126).

Tracks are padded to a fixed length V with a weight mask (0 = padding).
Where the JAX package maps one landmark with ``vmap``, these take leading
batch dimensions: poses R (..., V, 3, 3), t (..., V, 3), uv (..., V, 2),
weights (..., V).
"""

import numpy as np
import torch

from slam_tricks_tpu_torch.manifolds import se3


def _reproject(poses, X):
    """p_cam (..., V, 3) of points X (..., 3) in every view."""
    return (poses.R @ X[..., None, :, None])[..., 0] + poses.t


def triangulate_nview_dlt(poses, uv, weights):
    """One landmark a batch entry from its padded views: the weighted
    linear system of u (r3 X + t3) - (r1 X + t1) = 0 and its v twin, solved
    through its 3x3 normal equations (+1e-12 I). Returns (X (..., 3),
    residual RMS (...) over the active views)."""
    R, t = poses.R, poses.t
    u, v, w = uv[..., 0], uv[..., 1], weights
    A1 = u[..., None] * R[..., 2, :] - R[..., 0, :]
    A2 = v[..., None] * R[..., 2, :] - R[..., 1, :]
    b1 = t[..., 0] - u * t[..., 2]
    b2 = t[..., 1] - v * t[..., 2]
    A = torch.cat([A1 * w[..., None], A2 * w[..., None]], dim=-2)
    b = torch.cat([b1 * w, b2 * w], dim=-1)
    AtA = A.mT @ A + 1e-12 * torch.eye(3, dtype=A.dtype, device=A.device)
    X = torch.linalg.solve(AtA, (A.mT @ b[..., None])[..., 0])
    pc = _reproject(poses, X)
    r2 = ((pc[..., :2] / pc[..., 2:] - uv) ** 2).sum(dim=-1) * w
    rms = torch.sqrt(r2.sum(dim=-1) / torch.clamp_min(w.sum(dim=-1), 1.0))
    return X, rms


def refine_point_gn(poses, uv, weights, X0, iters=5):
    """`iters` Gauss-Newton steps a landmark on its weighted reprojection
    cost (the st20 per-landmark Ceres refinement), depth clamped at 1e-6.
    Returns X (..., 3)."""
    X = X0
    eye = 1e-10 * torch.eye(3, dtype=X0.dtype, device=X0.device)
    for _ in range(iters):
        pc = _reproject(poses, X)
        z = torch.clamp_min(pc[..., 2], 1e-6)
        r = (pc[..., :2] / z[..., None] - uv) * weights[..., None]
        iz = 1.0 / z
        zero = torch.zeros_like(iz)
        head = torch.stack([
            torch.stack([iz, zero, -pc[..., 0] * iz * iz], dim=-1),
            torch.stack([zero, iz, -pc[..., 1] * iz * iz], dim=-1),
        ], dim=-2)                                    # (..., V, 2, 3)
        J = (head @ poses.R) * weights[..., None, None]
        H = torch.einsum("...vri,...vrj->...ij", J, J)
        g = torch.einsum("...vri,...vr->...i", J, r)
        X = X + torch.linalg.solve(H + eye, -g)
    return X


def triangulate_tracks(poses_all, cam_idx_padded, uv_padded, w_padded,
                       refine_iters=5):
    """L landmarks with padded tracks: poses_all SE3 (C,), cam_idx_padded
    (L, V) int, uv_padded (L, V, 2), w_padded (L, V). The DLT, then
    `refine_iters` Gauss-Newton steps. Returns (X (L, 3), rms (L,))."""
    cams = cam_idx_padded.long()
    P = se3.SE3(poses_all.R[cams], poses_all.t[cams])
    X0, _ = triangulate_nview_dlt(P, uv_padded, w_padded)
    X = refine_point_gn(P, uv_padded, w_padded, X0, refine_iters)
    pc = _reproject(P, X)
    pred = pc[..., :2] / torch.clamp_min(pc[..., 2:], 1e-6)
    r2 = ((pred - uv_padded) ** 2).sum(dim=-1) * w_padded
    rms = torch.sqrt(r2.sum(dim=-1)
                     / torch.clamp_min(w_padded.sum(dim=-1), 1.0))
    return X, rms


def tracks_from_obs(obs, n_points, max_track=None):
    """Host side: flat observations (``sim.BAObservations``) -> padded
    tracks (cams (L, V) int32, uv (L, V, 2), w (L, V)) for
    ``triangulate_tracks``, on the observations' device: each landmark's
    live observations in input order, cut at max_track (default: the
    longest track)."""
    cam_idx = obs.cam_idx.cpu().numpy()
    lm_idx = obs.lm_idx.cpu().numpy()
    uv = obs.uv.cpu().numpy()
    w = obs.weight.cpu().numpy()
    active = w > 0
    lengths = np.bincount(lm_idx[active], minlength=n_points)
    V = int(lengths.max()) if max_track is None else max_track
    cams = np.zeros((n_points, V), np.int32)
    uvs = np.zeros((n_points, V, 2), uv.dtype)
    ws = np.zeros((n_points, V), w.dtype)
    fill = np.zeros(n_points, np.int32)
    for n in np.nonzero(active)[0]:
        lm = lm_idx[n]
        k = fill[lm]
        if k < V:
            cams[lm, k] = cam_idx[n]
            uvs[lm, k] = uv[n]
            ws[lm, k] = w[n]
            fill[lm] = k + 1
    device = obs.uv.device
    return (torch.as_tensor(cams, device=device),
            torch.as_tensor(uvs, device=device),
            torch.as_tensor(ws, device=device))
