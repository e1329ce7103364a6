"""Batched PnP Gauss-Newton with analytic Jacobians (port of
``slam_tricks_tpu/solvers/pnp.py``; the st17 SelfGaussNewton archetype,
solver.hpp:387-462).

The closed-form reprojection Jacobians (``residuals.reprojection``) and the
unrolled 6x6 Cholesky (``ops.smallchol``, through
``common.solve_damped_normal``) over a batch of problems: one
linearization is a single batched pass over the observations. A fixed
count of masked steps with no host sync inside the loop, as in the JAX
package. Parameterization: SO(3) (+) R^3, tangent [omega, dt].
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import se3, so3
from slam_tricks_tpu_torch.residuals.reprojection import \
    reproject_normalized_jacobians
from slam_tricks_tpu_torch.solvers.common import solve_damped_normal


class PnPResult(NamedTuple):
    T: se3.SE3
    cost: torch.Tensor
    iterations: torch.Tensor


def solve_pnp_batched(T0, points, uv, *, iters=10, damping=1e-8, xtol=1e-12,
                      weights=None):
    """B problems: T0 an SE3 of R (B, 3, 3), t (B, 3) (T_cw), points
    (B, M, 3) world, uv (B, M, 2) normalized-plane observations, weights
    (B, M) or None. Returns PnPResult with cost (B,) and iterations (B,)
    int32: a problem stops counting once its step is shorter than xtol or
    not finite, and takes zero steps from then on."""
    dtype, device = points.dtype, points.device
    B = points.shape[0]
    sw = (torch.ones(points.shape[:2], dtype=dtype, device=device)
          if weights is None else torch.sqrt(weights))[..., None]

    def linearize(T):
        pred, Jp, _ = reproject_normalized_jacobians(
            se3.SE3(T.R[:, None], T.t[:, None]), points)
        r = (pred - uv) * sw
        J = Jp * sw[..., None]
        H = torch.einsum("bmri,bmrj->bij", J, J)
        g = torch.einsum("bmri,bmr->bi", J, r)
        return H, g, 0.5 * (r * r).sum(dim=(1, 2))

    T = T0
    done = torch.zeros(B, dtype=torch.bool, device=device)
    it = torch.zeros(B, dtype=torch.int32, device=device)
    for _ in range(iters):
        H, g, _ = linearize(T)
        delta, bad = solve_damped_normal(H, g, damping)   # 6x6: smallchol
        small = (delta * delta).sum(dim=-1) < xtol * xtol
        d = torch.where((done | bad)[:, None], torch.zeros_like(delta), delta)
        T = se3.SE3(so3.retract(T.R, d[:, :3]), T.t + d[:, 3:])
        it = it + (~done).to(torch.int32)
        done = done | small | bad
    return PnPResult(T=T, cost=linearize(T)[2], iterations=it)


def solve_pnp(T0, points, uv, *, iters=10, damping=1e-8, xtol=1e-12,
              weights=None):
    """One problem: T0 SE3 (T_cw), points (M, 3), uv (M, 2), weights (M,)
    or None: ``solve_pnp_batched`` on a batch of one."""
    res = solve_pnp_batched(
        se3.SE3(T0.R[None], T0.t[None]), points[None], uv[None], iters=iters,
        damping=damping, xtol=xtol,
        weights=None if weights is None else weights[None])
    return PnPResult(T=se3.SE3(res.T.R[0], res.T.t[0]), cost=res.cost[0],
                     iterations=res.iterations[0])
