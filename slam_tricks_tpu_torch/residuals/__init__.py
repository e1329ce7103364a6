"""Residual layer: camera models, robust losses and the pose-graph
factors."""

from slam_tricks_tpu_torch.residuals import camera, posegraph, robust  # noqa: F401
