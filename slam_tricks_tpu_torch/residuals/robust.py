"""Robust losses (M-estimators) and their IRLS weights (port of
``slam_tricks_tpu/residuals/robust.py``).

A loss maps the squared residual norm s = ‖r‖² to rho(s), and its weight is
rho'(s); the solvers rescale each residual and its Jacobian by
sqrt(w · weight(s)) and count 0.5 · w · rho(s) as its cost. The formulas
are the JAX package's, branch-free (``torch.where``).

The JAX ``Loss`` is a pair of closures. The port's ``Loss`` is the loss's
name and its one parameter, so that the ``ba_assemble`` kernel can take it
(as ``KINDS[kind]`` and the parameter); ``rho`` and ``weight`` are its
torch formulas.
"""

from typing import NamedTuple

import torch

# the kernel's codes (csrc/ba_assemble.cu, LossKind)
KINDS = {"trivial": 0, "huber": 1, "cauchy": 2, "tukey": 3, "chi2_gate": 4}


class Loss(NamedTuple):
    kind: str       # a key of KINDS
    param: float    # huber's delta, cauchy's and tukey's c, the gate's
    #                 threshold_sq; unused by trivial

    def rho(self, s):
        """The robustified cost of squared norms s."""
        if self.kind == "trivial":
            return s
        if self.kind == "huber":
            d = self.param
            d2 = d * d
            return torch.where(s <= d2, s,
                               2.0 * d * torch.sqrt(torch.clamp_min(s, d2)) - d2)
        if self.kind == "cauchy":
            c2 = self.param * self.param
            return c2 * torch.log1p(s / c2)
        if self.kind == "tukey":
            c2 = self.param * self.param
            inner = 1.0 - (1.0 - s / c2) ** 3
            return torch.where(s <= c2, c2 / 3.0 * inner,
                               torch.full_like(s, c2 / 3.0))
        if self.kind == "chi2_gate":
            return torch.where(s <= self.param, s,
                               torch.full_like(s, self.param))
        raise ValueError(f"unknown loss kind {self.kind!r}")

    def weight(self, s):
        """The IRLS weight rho'(s) of squared norms s."""
        if self.kind == "trivial":
            return torch.ones_like(s)
        if self.kind == "huber":
            d = self.param
            d2 = d * d
            return torch.where(s <= d2, torch.ones_like(s),
                               d / torch.sqrt(torch.clamp_min(s, d2)))
        if self.kind == "cauchy":
            c2 = self.param * self.param
            return 1.0 / (1.0 + s / c2)
        if self.kind == "tukey":
            c2 = self.param * self.param
            return torch.where(s <= c2, (1.0 - s / c2) ** 2,
                               torch.zeros_like(s))
        if self.kind == "chi2_gate":
            return torch.where(s <= self.param, torch.ones_like(s),
                               torch.zeros_like(s))
        raise ValueError(f"unknown loss kind {self.kind!r}")


def check(loss):
    """Raise TypeError unless loss is None or the port's Loss."""
    if loss is not None and not (isinstance(loss, Loss) and loss.kind in KINDS):
        raise TypeError(f"loss must be None or a slam_tricks_tpu_torch "
                        f"residuals.robust.Loss, got {loss!r}")


def trivial():
    return Loss("trivial", 0.0)


def huber(delta=1.0):
    return Loss("huber", float(delta))


def cauchy(c=1.0):
    return Loss("cauchy", float(c))


def tukey(c=4.685):
    return Loss("tukey", float(c))


def chi2_gate(threshold_sq):
    """Hard chi-square gate as a loss weight: a residual whose squared norm
    exceeds threshold_sq gets weight 0 and a constant cost."""
    return Loss("chi2_gate", float(threshold_sq))
