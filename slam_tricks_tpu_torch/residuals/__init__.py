"""Residual layer: camera models (BAL's 9-parameter camera in ``bal``),
robust losses, the pose-graph factors,
reprojection, ICP, epipolar, calibration and the small fit residuals."""

from slam_tricks_tpu_torch.residuals import (  # noqa: F401
    bal,
    calib,
    camera,
    epipolar,
    icp,
    posegraph,
    robust,
    simple,
)
from slam_tricks_tpu_torch.residuals.camera import (  # noqa: F401
    DistCoeffs,
    Intrinsics,
    distort_normalized,
    distort_pixel,
    undistort_point_gn,
    undistort_points_fast,
    undistort_points_gn,
)
from slam_tricks_tpu_torch.residuals.reprojection import (  # noqa: F401
    reproject_normalized,
    reproject_normalized_jacobians,
    reproject_pixel,
)
