"""State estimation (port of ``slam_tricks_tpu/estimation``): the SE(3)
error-state Kalman filter (st4's intended solver), strapdown INS
mechanization (st14), on-manifold IMU preintegration, the inertial MAP
smoothers built on it (dense, chain with the multi-right-hand-side
``tridiag_solve``, and visual-inertial bundle adjustment) and the
closed-form visual-inertial initializer."""

from slam_tricks_tpu_torch.estimation.eskf import (  # noqa: F401
    ESKFState,
    filter_trajectory,
    predict,
    update_pose,
)
from slam_tricks_tpu_torch.estimation.preintegration import (  # noqa: F401
    PreintegratedImu,
    bias_corrected,
    imu_residual,
    preintegrate,
    whiten,
)
from slam_tricks_tpu_torch.estimation.vi_chain import (  # noqa: F401
    ViChainState,
    solve_vi_chain,
    vi_chain_covariances,
)
from slam_tricks_tpu_torch.estimation.vi_init import (  # noqa: F401
    ViInit,
    vi_initialize,
)
from slam_tricks_tpu_torch.estimation.vi_smoother import (  # noqa: F401
    ViSimData,
    ViSolution,
    dead_reckon,
    preintegrate_segments,
    simulate_vi,
    simulate_vi_landmarks,
    solve_vi_ba,
    solve_vi_smoother,
)
from slam_tricks_tpu_torch.estimation.ins import (  # noqa: F401
    ELLIPSOIDS,
    INSState,
    mechanize_step,
    mechanize_trajectory,
    normal_gravity,
    radii,
)
