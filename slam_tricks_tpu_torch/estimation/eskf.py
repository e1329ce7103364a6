"""Error-state Kalman filter on SE(3) (port of
``slam_tricks_tpu/estimation/eskf.py``), over the st4 simulation setup
(noisy pose observations of a smooth trajectory).

State: T in SE(3) with a 6x6 tangent covariance P (right perturbation
T_true = T_est exp(delta), delta ~ N(0, P), ordering [rho, omega]).

- predict with relative odometry Z (+ process noise Q):
    T <- T Z,   P <- Adj(Z^-1) P Adj(Z^-1)^T + Q
- update with an absolute pose observation T_obs (+ noise R):
    y = log(T^-1 T_obs),  S = P + R,  K = P S^-1,
    T <- T exp(K y),      P <- (I - K) P (I - K)^T + K R K^T   (Joseph form)

``filter_trajectory`` is a loop over the sequence (the JAX package's
``lax.scan``); a masked step computes the update and then selects the
predicted state, as the JAX package's does.
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import se3


class ESKFState(NamedTuple):
    T: se3.SE3
    P: torch.Tensor  # (6, 6)


def predict(state, Z, Q):
    """Propagate through the relative motion Z with process noise Q (6, 6)."""
    Ad = se3.adj(se3.inv(Z))
    return ESKFState(T=se3.mul(state.T, Z), P=Ad @ state.P @ Ad.mT + Q)


def update_pose(state, T_obs, R_cov):
    """Absolute-pose measurement update (Joseph-stabilized)."""
    y = se3.log(se3.mul(se3.inv(state.T), T_obs))
    S = state.P + R_cov
    K = torch.linalg.solve_ex(S.mT, state.P.mT)[0].mT   # P S^-1
    delta = K @ y
    T_new = se3.mul(state.T, se3.exp(delta))
    IK = torch.eye(6, dtype=state.P.dtype, device=state.P.device) - K
    P_new = IK @ state.P @ IK.mT + K @ R_cov @ K.mT
    return ESKFState(T=T_new, P=P_new)


def filter_trajectory(T0, P0, odometry, observations, obs_mask, Q, R_cov):
    """Predict and update over a sequence: odometry, stacked SE3 (N,)
    relative motions; observations, stacked SE3 (N,) absolute poses;
    obs_mask (N,) bool, False where the step keeps its prediction.
    Returns (stacked filtered poses (N,), final state)."""
    state = ESKFState(T=T0, P=P0)
    Rs, ts = [], []
    for k in range(obs_mask.shape[0]):
        state = predict(state, se3.SE3(odometry.R[k], odometry.t[k]), Q)
        updated = update_pose(state, se3.SE3(observations.R[k],
                                             observations.t[k]), R_cov)
        m = obs_mask[k]
        state = ESKFState(
            T=se3.SE3(torch.where(m, updated.T.R, state.T.R),
                      torch.where(m, updated.T.t, state.T.t)),
            P=torch.where(m, updated.P, state.P))
        Rs.append(state.T.R)
        ts.append(state.T.t)
    return se3.SE3(torch.stack(Rs), torch.stack(ts)), state
