"""Evaluation metrics: ATE, trajectory alignment, reprojection statistics
(port of ``slam_tricks_tpu/evaluation/metrics.py``). Tensors in, tensors
out, on the inputs' device; poses are stacked ``se3.SE3`` (leading axis =
time)."""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.residuals.icp import umeyama


class ErrorStats(NamedTuple):
    mean: torch.Tensor
    sigma: torch.Tensor
    rmse: torch.Tensor
    max: torch.Tensor


def stats(errors):
    """Summary statistics of a flat error array (population sigma)."""
    e = errors.reshape(-1)
    return ErrorStats(mean=e.mean(), sigma=e.std(correction=0),
                      rmse=torch.sqrt((e * e).mean()), max=e.abs().max())


def ate_rmse(poses_est, poses_ref):
    """Absolute trajectory error: the RMSE of ‖log(T_ref^-1 T_est)‖."""
    xi = se3.log(se3.mul(se3.inv(poses_ref), poses_est))
    return torch.sqrt((xi * xi).sum(dim=1).mean())


def ate_translation_rmse(poses_est, poses_ref):
    d = poses_est.t - poses_ref.t
    return torch.sqrt((d * d).sum(dim=1).mean())


def align_trajectories(poses_est, poses_ref, with_scale=True):
    """The estimated poses moved by the similarity that best maps their
    camera centers (c = -Rᵀ t) onto the reference's (``umeyama``); the
    rotations turn by the same global rotation."""
    c_est = -torch.einsum("nij,ni->nj", poses_est.R, poses_est.t)
    c_ref = -torch.einsum("nij,ni->nj", poses_ref.R, poses_ref.t)
    R, t, s = umeyama(c_est, c_ref, with_scale=with_scale)
    new_R = torch.einsum("nij,kj->nik", poses_est.R, R)
    new_c = s * torch.einsum("ij,nj->ni", R, c_est) + t
    new_t = -torch.einsum("nij,nj->ni", new_R, new_c)
    return se3.SE3(new_R, new_t)


def reprojection_rms(poses, points, cam_idx, lm_idx, uv, weight):
    """Weighted RMS of the normalized-plane reprojection residuals."""
    cam, lm = cam_idx.long(), lm_idx.long()
    pc = (poses.R[cam] @ points[lm][..., None])[..., 0] + poses.t[cam]
    r = pc[:, :2] / pc[:, 2:] - uv
    wsum = torch.clamp_min(weight.sum(), 1.0)
    return torch.sqrt((weight[:, None] * r * r).sum() / (2.0 * wsum))
