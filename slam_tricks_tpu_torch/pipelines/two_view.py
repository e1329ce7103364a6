"""Two-view reconstruction: essential-matrix start, pose recovery,
triangulation and a joint 2-camera bundle adjustment (port of
``slam_tricks_tpu/pipelines/two_view.py``; st22-two-view main.cpp:8-40,
plus the joint refinement the reference leaves to st20).

The refinement is the slot-major Schur solver (``schur_flat_sm``, through
the ``ba_assemble`` kernel and ``spd_solve`` at n = 12 on the card) on a
(K = 2, L = N) grid: slot 0 of landmark l is its camera-0 observation,
slot 1 its camera-1 one. The JAX package writes that grid by hand with a
bf16 camera one-hot; here the port's layout builder
(``schur_flat_sm.slot_work_from_table``, the second half of
``build_slot_work``, which would pad each track to 8 slots) lays it out
from a two-slot track table and builds the summation tables and the
kernel's camera index. A point behind a camera has weight 0 and no live
slot; a weight-0 slot adds exact zeros in ``ba_assemble``, so the sums are
the JAX package's.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.initialization import essential_8pt, recover_pose
from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
from slam_tricks_tpu_torch.solvers import schur_flat_sm
from slam_tricks_tpu_torch.solvers.schur import TrackTable


class TwoViewResult(NamedTuple):
    T_12: se3.SE3          # cam 1 -> cam 2, ||t|| = 1 gauge
    points: torch.Tensor   # (N, 3) in the cam-1 frame
    final_cost: torch.Tensor
    n_cheiral: torch.Tensor


def two_view_work(uv1, uv2, w):
    """The (K = 2, L = N) ``SlotWork`` of two views' correspondences
    uv1, uv2 (N, 2) with slot weights w (N,): camera 0 in slot 0, camera 1
    in slot 1, a slot live where w > 0."""
    n, device = uv1.shape[0], uv1.device
    lm = torch.arange(n, dtype=torch.int32, device=device)
    obs = BAObservations(
        cam_idx=torch.cat([torch.zeros_like(lm), torch.ones_like(lm)]),
        lm_idx=torch.cat([lm, lm]), uv=torch.cat([uv1, uv2]),
        weight=torch.cat([w, w]))
    live = (w > 0).cpu().numpy()
    table = TrackTable(
        obs_idx=np.stack([np.arange(n), n + np.arange(n)], 1).astype(
            np.int32),
        mask=np.stack([live, live], 1).astype(np.float32))
    return schur_flat_sm.slot_work_from_table(obs, table, 2, uv1.dtype)


def solve_two_view(uv1, uv2, *, refine_iters=20, weights=None):
    """uv1, uv2 (N, 2) normalized-plane correspondences, weights (N,) or
    None. Camera 0 is fixed at the identity; the scale gauge ||t|| = 1 is
    set by renormalizing after the solve (the reference rescales to the
    truth, st22 main.cpp:21-27). Returns a TwoViewResult; n_cheiral is the
    (weighted) count of points in front of both cameras at the start."""
    dtype, device = uv1.dtype, uv1.device
    E = essential_8pt(uv1, uv2, weights)
    R, t, n_good, X = recover_pose(E, uv1, uv2, weights)
    poses0 = se3.SE3(
        torch.stack([torch.eye(3, dtype=dtype, device=device), R]),
        torch.stack([torch.zeros(3, dtype=dtype, device=device), t]))
    # badly triangulated points (behind a camera, not finite) get weight 0
    depth_ok = (X[:, 2] > 1e-3) & torch.isfinite(X).all(dim=1)
    X_safe = torch.where(depth_ok[:, None], X, torch.ones_like(X))
    w1 = torch.ones_like(uv1[:, 0]) if weights is None else weights
    work = two_view_work(uv1, uv2, w1 * depth_ok.to(dtype))
    final = schur_flat_sm.solve_ba_flat_sm(
        poses0, X_safe, work,
        fixed_mask=torch.tensor([True, False], device=device),
        max_iters=refine_iters)
    R2, t2 = final.poses.R[1], final.poses.t[1]
    scale = torch.linalg.vector_norm(t2)
    return TwoViewResult(T_12=se3.SE3(R2, t2 / scale),
                         points=final.points / scale,
                         final_cost=final.cost, n_cheiral=n_good)
