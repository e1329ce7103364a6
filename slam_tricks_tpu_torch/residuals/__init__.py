"""Camera models."""

from slam_tricks_tpu_torch.residuals import camera, robust  # noqa: F401
