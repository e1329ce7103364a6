"""Sim(3) pose-graph optimization: scale-drift-aware monocular loop closing.

Port of ``slam_tricks_tpu/solvers/posegraph_sim3.py``. Monocular odometry
drifts in scale as well as pose, which an SE(3) pose graph cannot absorb;
lifting the poses to Sim(3) with relative-similarity factors
r = log(Z^-1 S_i^-1 S_j) in R^7 makes the drift observable (Strasdat et
al., RSS 2010). The Sim(3) twin of ``posegraph.solve_pose_graph``: the
same LM loop, damping and gauge, with 7-dim tangent blocks, the dense
(7N, 7N) system solved by ``ops.spd_solve`` (the CUDA kernel on the card).
One fixed pose removes the 7 gauge freedoms.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import sim3, so3
from slam_tricks_tpu_torch.residuals.posegraph import relative_sim3_residual
from slam_tricks_tpu_torch.solvers.common import (first_camera_fixed,
                                                  set_full_precision)
from slam_tricks_tpu_torch.solvers.posegraph import (dense_step,
                                                     dense_tables,
                                                     edge_cost,
                                                     edge_linearize,
                                                     lm_solve)


def ad_sim3(xi):
    """(..., 7, 7) adjoint of the algebra at xi = [rho, omega, sigma]:
    [[hat(omega) + sigma I, hat(rho), -rho], [0, hat(omega), 0], [0, 0, 0]],
    so that Adj(exp(xi)) = exp(ad(xi))."""
    W = so3.hat(xi[..., 3:6])
    rho = xi[..., :3]
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    top = torch.cat([W + xi[..., 6, None, None] * eye, so3.hat(rho),
                     -rho[..., None]], dim=-1)
    mid = torch.cat([torch.zeros_like(W), W, torch.zeros_like(W[..., :1])],
                    dim=-1)
    return torch.cat([top, mid, torch.zeros_like(top[..., :1, :])], dim=-2)


class Sim3GraphState(NamedTuple):
    poses: sim3.Sim3
    cost: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    it: int             # LM iterations run
    done: bool          # stopped on the step-size test or a bad step


def _edge_linearize(poses, i_idx, j_idx, Z, sqrt_info):
    """Per-edge whitened residual and Jacobians with respect to right
    perturbations of S_i, S_j: (r (E, 7), Ji (E, 7, 7), Jj (E, 7, 7))."""
    return edge_linearize(sim3, relative_sim3_residual, ad_sim3, poses,
                          i_idx, j_idx, Z, sqrt_info)


def _pg_cost(poses, i_idx, j_idx, Z, sqrt_info):
    return edge_cost(relative_sim3_residual, poses, i_idx, j_idx, Z,
                     sqrt_info)


def solve_pose_graph_sim3(poses0, i_idx, j_idx, Z, sqrt_info=None, *,
                          fixed_mask=None, max_iters=50, lambda_init=1e-6,
                          xtol=1e-12, costs=None):
    """LM Sim(3) pose-graph solve. poses0: stacked Sim3 (N,); edges (E,)
    index tensors with stacked Sim3 measurements Z and optional (E, 7, 7)
    square-root information; pose 0 fixed by default. The predicted
    reduction uses the damped diagonal, lam d (1 + lam), as the JAX
    package's does. If `costs` is a list, the costs are appended to it.
    Returns Sim3GraphState."""
    set_full_precision()
    N = poses0.t.shape[0]
    E = i_idx.shape[0]
    dtype, device = poses0.t.dtype, poses0.t.device
    i_idx, j_idx = i_idx.long(), j_idx.long()
    if sqrt_info is None:
        sqrt_info = torch.eye(7, dtype=dtype, device=device).expand(E, 7, 7)
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(N, device)
    tables = dense_tables(i_idx, j_idx, N)

    def propose(poses, lam):
        r, Ji, Jj = _edge_linearize(poses, i_idx, j_idx, Z, sqrt_info)
        return dense_step(r, Ji, Jj, lam, fixed_mask, tables)

    out = lm_solve(poses0,
                   lambda p: _pg_cost(p, i_idx, j_idx, Z, sqrt_info),
                   propose, sim3.retract, max_iters=max_iters,
                   lambda_init=lambda_init, xtol=xtol, costs=costs)
    return Sim3GraphState(*out)
