"""Config layer (port of ``slam_tricks_tpu/config.py``; the reference
hard-codes everything, SURVEY §5 "Config / flag system: None"). Plain frozen
dataclasses, so a config is a hashable set of plain settings, with
`replace()` for overrides and dict round-trips for serialization.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Dense GN/LM settings."""
    max_iters: int = 50
    lambda_init: float = 1e-4
    xtol: float = 1e-12
    gtol: float = 0.0
    ftol: float = 0.0
    use_marquardt_scaling: bool = True

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Schur BA settings."""
    max_iters: int = 30
    lambda_init: float = 1e-4
    xtol: float = 1e-12
    gtol: float = 0.0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    n_hyps: int = 256
    inlier_thresh_sq: float = 1e-2
    n_refine: int = 5

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def to_dict(cfg):
    return dataclasses.asdict(cfg)


def from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
