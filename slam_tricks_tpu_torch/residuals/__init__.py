"""Camera models."""

from slam_tricks_tpu_torch.residuals import camera  # noqa: F401
