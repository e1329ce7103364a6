"""End-to-end problem pipelines: two-view reconstruction, Zhang
calibration (``pipelines.calibration``) and panorama stitching."""

from slam_tricks_tpu_torch.pipelines.panorama import (  # noqa: F401
    chain_to_middle,
    compose_panorama,
    pairwise_homography,
    stitch,
)
from slam_tricks_tpu_torch.pipelines.two_view import (  # noqa: F401
    TwoViewResult,
    solve_two_view,
)
