"""End-to-end problem pipelines: two-view reconstruction and Zhang
calibration (``pipelines.calibration``)."""

from slam_tricks_tpu_torch.pipelines.two_view import (  # noqa: F401
    TwoViewResult,
    solve_two_view,
)
