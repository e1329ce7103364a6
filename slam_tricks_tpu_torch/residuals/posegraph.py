"""Relative-pose factors of the pose graphs, batched over edges.

Port of ``slam_tricks_tpu/residuals/posegraph.py``: given a measurement
Z_ij ~ T_i^-1 T_j, the residual is log(Z_ij^-1 T_i^-1 T_j).
"""

from slam_tricks_tpu_torch.manifolds import se3, sim3


def relative_se3_residual(T_i, T_j, Z_ij):
    """(..., 6) log-residual of the relative-pose factor."""
    return se3.log(se3.mul(se3.inv(Z_ij), se3.mul(se3.inv(T_i), T_j)))


def relative_se3_residual_weighted(T_i, T_j, Z_ij, sqrt_info):
    """Whitened by a (..., 6, 6) square-root information matrix."""
    r = relative_se3_residual(T_i, T_j, Z_ij)
    return (sqrt_info @ r[..., None])[..., 0]


def relative_sim3_residual(S_i, S_j, Z_ij):
    """(..., 7) log-residual [rho, omega, sigma] of the relative-similarity
    factor, the scale-drift-aware loop-closing factor."""
    return sim3.log(sim3.mul(sim3.inv(Z_ij), sim3.mul(sim3.inv(S_i), S_j)))
