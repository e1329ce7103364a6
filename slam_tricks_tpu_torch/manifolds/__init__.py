"""Lie groups and the manifold interface, batched over leading dimensions,
dtype taken from the inputs."""

from slam_tricks_tpu_torch.manifolds import se2, se3, sim3, so2, so3  # noqa: F401
from slam_tricks_tpu_torch.manifolds.manifold import (  # noqa: F401
    Manifold,
    batched,
    euclidean,
    lie,
    product,
    so3_r3,
)
from slam_tricks_tpu_torch.manifolds.se2 import SE2  # noqa: F401
from slam_tricks_tpu_torch.manifolds.se3 import SE3  # noqa: F401
from slam_tricks_tpu_torch.manifolds.sim3 import Sim3  # noqa: F401
