"""Image front ends (the reference's L4): chessboard detection, optical
flow, direct alignment and ORB features. Plain torch on the card, no
kernel; board growth is host numpy."""

from slam_tricks_tpu_torch.frontend.chessboard import (  # noqa: F401
    corner_likelihood,
    detect_chessboard,
    detect_corners,
    estimate_orientations,
    grow_chessboards,
    refine_corners_subpixel,
    verify_corners,
)
from slam_tricks_tpu_torch.frontend.direct import (  # noqa: F401
    direct_pose_estimate,
    select_pixels,
)
from slam_tricks_tpu_torch.frontend.optical_flow import (  # noqa: F401
    build_pyramid,
    grid_seed_points,
    lk_track,
)
from slam_tricks_tpu_torch.frontend.orb import (  # noqa: F401
    OrbFeatures,
    orb_detect,
    orb_match,
)
