"""Levenberg-Marquardt over a manifold, for any residual function (port of
``slam_tricks_tpu/solvers/lm.py``).

The JAX package runs the whole solve in one ``lax.while_loop`` on the
device; here the loop runs on the host over device tensors, with one sync
a step (the accept and stop flags, read together). The residual and its
Jacobian (``common.linearize``, forward-mode ``torch.func.jacfwd``) are
recomputed only after an ACCEPTED step; a rejected step reuses them, as
Ceres' LM does.

Control (Nielsen / Madsen damping, as the JAX package's):
  gain rho = (cost - cost_new) / (0.5 delta^T (lam D delta - g))
  accept: lam *= max(1/3, 1 - (2 rho - 1)^3); nu = 2
  reject: lam *= nu; nu *= 2
Stops: an accepted step with ||delta||^2 < xtol^2, max |g| < gtol, with
ftol > 0 an accepted decrease below ftol * cost, or a non-finite step.
"""

import torch

from slam_tricks_tpu_torch.solvers.common import (SolveResult, ata, atb,
                                                  leaves, linearize,
                                                  solve_damped_normal)


def levenberg_marquardt(residual_fn, x0, manifold, args=(), *, max_iters=50,
                        lambda_init=1e-4, xtol=1e-12, gtol=1e-12, ftol=0.0,
                        weights=None, use_marquardt_scaling=True,
                        callback=None):
    """Minimize 0.5 ||residual_fn(x, *args)||^2 over `manifold` from x0 (a
    nest of tensors on one device). weights: per-residual weights, applied
    as sqrt(w) r. callback(iteration, cost, lam): called after each step
    with the 0-based step count and the state it leaves (the Ceres
    IterationCallback role). Returns a ``SolveResult``."""
    x00 = leaves(x0)[0]
    dtype, device = x00.dtype, x00.device
    sw = (None if weights is None
          else torch.sqrt(torch.as_tensor(weights, device=device)
                          .reshape(-1).to(dtype)))
    pred_floor = 1e-300 if dtype == torch.float64 else 1e-30

    def lin(x):
        r, J = linearize(residual_fn, manifold, x, args)
        return (r, J) if sw is None else (r * sw, J * sw[:, None])

    def residual(x):
        r = residual_fn(x, *args).reshape(-1)
        return r if sw is None else r * sw

    x = x0
    r, J = lin(x)
    cost = 0.5 * torch.sum(r * r)
    lam = torch.tensor(lambda_init, dtype=dtype, device=device)
    nu = torch.tensor(2.0, dtype=dtype, device=device)
    gnorm = torch.tensor(float("inf"), dtype=dtype, device=device)
    it, done = 0, False
    while not done and it < max_iters:
        H = ata(J)
        g = atb(J, r)
        gnorm = torch.max(torch.abs(g))
        delta, bad = solve_damped_normal(H, g, lam, use_marquardt_scaling)
        x_try = manifold.retract(x, delta)
        cost_try = 0.5 * torch.sum(residual(x_try) ** 2)

        D = (torch.clamp_min(torch.diagonal(H), 1e-12) if use_marquardt_scaling
             else torch.ones_like(g))
        pred = 0.5 * torch.dot(delta, lam * D * delta - g)
        rho = (cost - cost_try) / torch.clamp_min(pred, pred_floor)
        accept = (cost_try < cost) & torch.isfinite(cost_try) & ~bad
        lam_acc = lam * torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
        lam = torch.where(accept, lam_acc, lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)

        stop = (accept & (torch.sum(delta * delta) < xtol * xtol)) | bad
        stop = stop | (gnorm < gtol)
        if ftol > 0:
            stop = stop | (accept & (cost - cost_try < ftol * cost))
        accepted, done = torch.stack([accept, stop]).tolist()   # one sync
        if accepted:
            x, cost = x_try, cost_try
            r, J = lin(x)
        if callback is not None:
            callback(it, cost, lam)
        it += 1
    return SolveResult(x=x, cost=cost, iterations=it, converged=done,
                       grad_norm=gnorm)
