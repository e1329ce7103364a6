"""Dense Gauss-Newton over a manifold, one problem or a batch of them
(port of ``slam_tricks_tpu/solvers/gn.py``; the archetype the reference
repeats by hand, st17 SelfGaussNewton solver.hpp:387-462).

A fixed count of steps with no test on the data: a problem that has met
its step test, or whose step was not finite, takes masked zero steps from
then on, and its ``iterations`` stops counting. Nothing reads a tensor on
the host inside the loop, so a batch of problems runs as one stream of
batched operations (the JAX package's ``vmap``: here ``torch.func.vmap``
of the linearization, ``common.linearize``). The damped normal systems are
solved by ``common.solve_damped_normal``: for n <= 16 unknowns a problem
the unrolled small Cholesky over the whole batch, above by the
``spd_solve`` kernel, one call a problem.
"""

import torch

from slam_tricks_tpu_torch.solvers.common import (SolveResult, leaves,
                                                  linearize,
                                                  solve_damped_normal,
                                                  tree_map)


def _with_tensors(args, tensors):
    """args with its tensors replaced, in order, by `tensors`: the batched
    functions map over the tensors of args alone, and its other leaves
    (numbers, None) reach the residual as they are."""
    it = iter(tensors)
    return tree_map(lambda _: next(it), args)


def gauss_newton_batched(residual_fn, x0_batch, manifold, args_batch=(), *,
                         iters=10, damping=0.0, xtol=1e-10, weights=None):
    """Gauss-Newton on B independent problems: x0_batch and every tensor
    of args_batch carry a leading batch dimension B, and its other leaves
    (numbers, None) are shared by the batch as they are; residual_fn(x,
    *args) and the manifold see one problem. weights: per-residual weights
    of one problem (flat, shared by the batch), applied as sqrt(w) r.
    Returns a ``SolveResult`` of tensors: x batched, cost (B,), iterations
    (B,) int32, converged (B,) bool, grad_norm NaN (not computed, as in the
    JAX package)."""
    x = x0_batch
    x00 = leaves(x)[0]
    dtype, device = x00.dtype, x00.device
    B = x00.shape[0]
    sw = (None if weights is None
          else torch.sqrt(torch.as_tensor(weights, device=device)
                          .reshape(-1).to(dtype)))
    arg_tensors = leaves(args_batch)
    lin = torch.func.vmap(lambda x_, *t: linearize(
        residual_fn, manifold, x_, _with_tensors(args_batch, t)))
    retract = torch.func.vmap(manifold.retract)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    it = torch.zeros(B, dtype=torch.int32, device=device)
    for _ in range(iters):
        r, J = lin(x, *arg_tensors)
        if sw is not None:
            r, J = r * sw, J * sw[:, None]
        H = J.mT @ J
        g = (J.mT @ r[..., None])[..., 0]
        delta, bad = solve_damped_normal(H, g, damping)
        small = (delta * delta).sum(dim=-1) < xtol * xtol
        x = retract(x, torch.where((done | bad)[:, None],
                                   torch.zeros_like(delta), delta))
        it = it + (~done).to(torch.int32)
        done = done | small | bad
    r = torch.func.vmap(lambda x_, *t: residual_fn(
        x_, *_with_tensors(args_batch, t)).reshape(-1))(x, *arg_tensors)
    if sw is not None:
        r = r * sw
    return SolveResult(x=x, cost=0.5 * (r * r).sum(dim=-1), iterations=it,
                       converged=done,
                       grad_norm=torch.full((B,), float("nan"), dtype=dtype,
                                            device=device))


def gauss_newton(residual_fn, x0, manifold, args=(), *, iters=10,
                 damping=0.0, xtol=1e-10, weights=None):
    """Gauss-Newton on one problem: ``gauss_newton_batched`` on a batch of
    one. residual_fn(x, *args) -> residuals of any shape (flattened).
    Returns a ``SolveResult`` with 0-d cost, iterations and converged."""
    res = gauss_newton_batched(
        residual_fn, tree_map(lambda a: a[None], x0), manifold,
        tree_map(lambda a: a[None], tuple(args)), iters=iters,
        damping=damping, xtol=xtol, weights=weights)
    return SolveResult(*(tree_map(lambda a: a[0], f) for f in res))
