"""RANSAC with every hypothesis evaluated in one batched computation (port
of ``slam_tricks_tpu/initialization/ransac.py``; st7 parabola.hpp:132-153,
st12 ransac.hpp:18-247).

The JAX package draws each hypothesis's subset with
``jax.random.choice(key, replace=False, p=...)``; no torch stream gives
the same draws, so the port takes a ``torch.Generator`` in place of the
key: without sample weights a subset is the first `subset_size` of a
random permutation (``torch.rand(...).argsort``), with them
``torch.multinomial`` without replacement. The rest is the JAX package's:
the minimal fits and their inlier counts (``hypothesis_scores``, the
per-subset functions mapped with ``torch.func.vmap``), the best by argmax
(ties to the first), a weighted refit on its inliers, and the inlier set
under the refit.
"""

from typing import Callable, NamedTuple

import torch

from slam_tricks_tpu_torch.solvers.common import leaves, tree_map


class RansacResult(NamedTuple):
    params: torch.Tensor           # the best model after the weighted refit
    inlier_mask: torch.Tensor      # (N,) bool
    n_inliers: torch.Tensor
    best_hypothesis: torch.Tensor  # the best minimal fit's params


def draw_subsets(generator, n, n_hyps, subset_size, sample_weights=None,
                 device=None):
    """(n_hyps, subset_size) int64 indices into n samples, each row without
    repeats, drawn on the generator's device and moved to `device`: the
    first subset_size of a random permutation, or with sample_weights (N,)
    (zero excludes a row) ``torch.multinomial`` without replacement."""
    gdev = generator.device
    if sample_weights is None:
        u = torch.rand(n_hyps, n, generator=generator, device=gdev)
        idx = u.argsort(dim=1)[:, :subset_size]
    else:
        p = sample_weights.to(gdev, torch.float64)
        p = p / torch.clamp_min(p.sum(), 1e-12)
        idx = torch.multinomial(p.expand(n_hyps, n), subset_size,
                                replacement=False, generator=generator)
    return idx.to(device)


def hypothesis_scores(data, idx, *, min_fit: Callable, residual_sq: Callable,
                      inlier_thresh_sq):
    """The minimal fits of the subsets idx (n_hyps, k) and their inlier
    counts: (params (n_hyps, ...), scores (n_hyps,) int64, -1 where a
    fit is not finite). min_fit(subset) and residual_sq(params, data) are
    the per-subset functions of ``ransac``."""
    params = torch.func.vmap(
        lambda i: min_fit(tree_map(lambda v: v[i], data)))(idx)
    r2 = torch.func.vmap(lambda p: residual_sq(p, data))(params)
    finite = torch.isfinite(params.reshape(params.shape[0], -1)).all(dim=1)
    count = (r2 < inlier_thresh_sq).sum(dim=1)
    return params, torch.where(finite, count, torch.full_like(count, -1))


def ransac(generator, data, *, min_fit: Callable, residual_sq: Callable,
           refit: Callable, subset_size: int, n_hyps: int = 256,
           inlier_thresh_sq: float = 1e-2, sample_weights=None):
    """RANSAC over `n_hyps` hypotheses in one batch.

    data: a tensor, or a nest of tuples (NamedTuples included), lists and
    dicts of tensors with leading axis N (the samples). min_fit(subset) ->
    params of a minimal subset; residual_sq(params, data) -> (N,) squared
    residuals; refit(data, weights (N,)) -> params, the weighted
    least-squares refit on the inliers. sample_weights: optional (N,)
    sampling weights (zero excludes a row from the subsets). generator: a
    ``torch.Generator`` in place of the JAX key."""
    x = leaves(data)[0]
    idx = draw_subsets(generator, x.shape[0], n_hyps, subset_size,
                       sample_weights, x.device)
    params_all, scores = hypothesis_scores(
        data, idx, min_fit=min_fit, residual_sq=residual_sq,
        inlier_thresh_sq=inlier_thresh_sq)
    best_params = params_all[torch.argmax(scores)]
    mask = residual_sq(best_params, data) < inlier_thresh_sq
    refined = refit(data, mask.to(x.dtype))
    final_mask = residual_sq(refined, data) < inlier_thresh_sq
    return RansacResult(params=refined, inlier_mask=final_mask,
                        n_inliers=final_mask.sum(),
                        best_hypothesis=best_params)


def ransac_iterative_refit(generator, data, *, min_fit, residual_sq, refit,
                           subset_size, n_hyps=256, inlier_thresh_sq=1e-2,
                           n_refine=5):
    """``ransac``, then `n_refine` rounds of re-gating and refitting: the
    reference's solveWithMeanShift (st12 ransac.hpp:37-94) with a fixed
    count."""
    res = ransac(generator, data, min_fit=min_fit, residual_sq=residual_sq,
                 refit=refit, subset_size=subset_size, n_hyps=n_hyps,
                 inlier_thresh_sq=inlier_thresh_sq)
    params, mask = res.params, res.inlier_mask
    dtype = leaves(data)[0].dtype
    for _ in range(n_refine):
        mask = residual_sq(params, data) < inlier_thresh_sq
        params = refit(data, mask.to(dtype))
    return RansacResult(params=params, inlier_mask=mask,
                        n_inliers=mask.sum(),
                        best_hypothesis=res.best_hypothesis)
