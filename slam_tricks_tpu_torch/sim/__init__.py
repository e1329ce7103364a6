"""Deterministic simulators."""

from slam_tricks_tpu_torch.sim.ba_scene import (  # noqa: F401
    BAObservations,
    BAScene,
    make_loop_scene,
    make_scene,
    make_trajectory_scene,
    perturb_scene,
)
from slam_tricks_tpu_torch.sim.trajectory import (  # noqa: F401
    PoseGraphProblem,
    make_pose_graph,
    spiral_poses,
)
