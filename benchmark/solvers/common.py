"""What the solver adapters share: the program's input types, built from
the benchmark's arrays, and the shape of a finished solve."""

from typing import NamedTuple

import numpy as np
import torch


class Inputs(NamedTuple):
    """The program's view of a scene, on its device and in its dtype."""
    obs: object               # the program's BAObservations
    n_cams: int
    n_points: int
    fixed: torch.Tensor       # (C,) bool
    dtype: torch.dtype


class Solved(NamedTuple):
    R: torch.Tensor           # (C, 3, 3)
    t: torch.Tensor           # (C, 3)
    X: torch.Tensor           # (L, 3), landmark order
    cost: torch.Tensor        # device scalar
    it: int                   # LM iterations taken
    costs: list               # device scalars: the start, then each step


def program_inputs(cam, lm, uv, w, n_cams, n_points, fixed, dtype, device):
    """Numpy observations (padded as the program's scenes are) as the
    program's ``BAObservations``."""
    from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def tensor(a):
        return torch.as_tensor(a, device=device)

    obs = BAObservations(cam_idx=tensor(cam.astype(np.int32)),
                         lm_idx=tensor(lm.astype(np.int32)),
                         uv=tensor(uv.astype(np_dtype)),
                         weight=tensor(w.astype(np_dtype)))
    return Inputs(obs, int(n_cams), int(n_points),
                  torch.as_tensor(fixed, device=device), dtype)


def se3(R, t):
    from slam_tricks_tpu_torch.manifolds import se3 as se3_mod
    return se3_mod.SE3(R, t)
