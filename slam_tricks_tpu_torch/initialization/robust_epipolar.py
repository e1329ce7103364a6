"""Robust fundamental / essential estimation: batched RANSAC over minimal
8-point fits, a Cauchy-IRLS polish and the chi-square inlier gate (port of
``slam_tricks_tpu/initialization/robust_epipolar.py``; st2-epipolar
epipolar.hpp:139-209).

Stage 1 draws `n_hyps` 8-point subsets (the first 8 of a random
permutation from a ``torch.Generator``, in place of the JAX key) and fits
them all as one batch of weighted 8-point solves over the whole set. The
IRLS scale is the median of the chi-square values as ``jnp.median`` takes
it, the mean of the two middle values for an even count (``median``;
``torch.median`` would return the lower).
"""

import torch

from slam_tricks_tpu_torch.initialization.eightpoint import (essential_8pt,
                                                             fundamental_8pt)
from slam_tricks_tpu_torch.initialization.ransac import draw_subsets
from slam_tricks_tpu_torch.residuals.epipolar import sampson

# chi-square (2 dof) 95% quantile: the standard 2-dof gate (the reference
# gates at sigma^2-scaled quantiles per octave, epipolar.hpp:176)
CHI2_2DOF_95 = 5.991


def median(x):
    """The median of x (N,) as ``jnp.median`` takes it: the mean of the two
    middle values for an even N (``torch.median`` returns the lower)."""
    return torch.quantile(x, 0.5)


def hypotheses(p1, p2, idx, sigma2, *, chi2_thresh=CHI2_2DOF_95,
               essential=False):
    """Stage 1 given the subsets idx (n_hyps, 8): each subset's 8-point fit
    (a weighted solve over all N with weight 1 on the subset) and its
    count of chi-square values below chi2_thresh (-1 where the fit is not
    finite). Returns (Fs (n_hyps, 3, 3), scores (n_hyps,))."""
    solve = essential_8pt if essential else fundamental_8pt
    w = torch.zeros(idx.shape[0], p1.shape[0], dtype=p1.dtype,
                    device=p1.device)
    w.scatter_(1, idx, 1.0)
    Fs = solve(p1, p2, w)
    c2 = sampson(Fs[:, None], p1, p2) / sigma2
    count = (c2 < chi2_thresh).sum(dim=1)
    finite = torch.isfinite(Fs).all(dim=(1, 2))
    return Fs, torch.where(finite, count, torch.full_like(count, -1))


def robust_fundamental(p1, p2, *, sigma2=1.0, n_rounds=6, n_hyps=256,
                       chi2_thresh=CHI2_2DOF_95, essential=False,
                       generator=None):
    """p1, p2 (N, 2) correspondences (pixels for F, the normalized plane
    for E); sigma2 a number or (N,) measurement variances; generator a
    ``torch.Generator`` (None: one on p1's device seeded 0). Returns
    (F or E (3, 3), inlier_mask (N,) bool, chi2 (N,))."""
    n, dtype, device = p1.shape[0], p1.dtype, p1.device
    sigma2 = torch.as_tensor(sigma2, dtype=dtype, device=device).expand(n)
    solve = essential_8pt if essential else fundamental_8pt
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def chi2_of(F):
        return sampson(F, p1, p2) / sigma2

    # stage 1: the minimal fits, the best by inlier count
    idx = draw_subsets(generator, n, n_hyps, 8, device=device)
    Fs, scores = hypotheses(p1, p2, idx, sigma2, chi2_thresh=chi2_thresh,
                            essential=essential)
    F = Fs[torch.argmax(scores)]

    # stage 2: Cauchy IRLS, scaled by the median
    for _ in range(n_rounds):
        c2 = chi2_of(F)
        scale = torch.clamp_min(median(c2), chi2_thresh)
        F = solve(p1, p2, 1.0 / (1.0 + c2 / scale))

    # stage 3: the hard chi-square gate and a final gated refit
    w = (chi2_of(F) < chi2_thresh).to(dtype)
    w = torch.where(w.sum() >= 8, w, torch.ones_like(w))
    F = solve(p1, p2, w)
    chi2 = chi2_of(F)
    return F, chi2 < chi2_thresh, chi2
