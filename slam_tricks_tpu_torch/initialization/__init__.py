"""Direct solvers of the initialization: the 8-point fundamental and
essential matrices and pose recovery, the DLT homography, N-view
triangulation, batched RANSAC, robust epipolar estimation and Zhang's
closed-form calibration."""

from slam_tricks_tpu_torch.initialization.eightpoint import (  # noqa: F401
    decompose_essential,
    essential_8pt,
    essential_from_fundamental,
    fundamental_8pt,
    hartley_normalize,
    recover_pose,
    triangulate_midpoint,
)
from slam_tricks_tpu_torch.initialization.homography import (  # noqa: F401
    apply_h,
    homography_dlt,
)
from slam_tricks_tpu_torch.initialization.ransac import (  # noqa: F401
    RansacResult,
    ransac,
    ransac_iterative_refit,
)
from slam_tricks_tpu_torch.initialization.robust_epipolar import (  # noqa: F401
    robust_fundamental,
)
from slam_tricks_tpu_torch.initialization.zhang import (  # noqa: F401
    calibrate_closed_form,
    extrinsics_from_homography,
    intrinsics_from_homographies,
)
