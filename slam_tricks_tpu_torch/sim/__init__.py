"""Deterministic simulators: the BA scenes, the pose graphs, the
calibration board, the two-view scene and the rolling-shutter and LiDAR
distortion simulators."""

from slam_tricks_tpu_torch.sim.ba_scene import (  # noqa: F401
    BAObservations,
    BAScene,
    make_loop_scene,
    make_scene,
    make_trajectory_scene,
    perturb_scene,
)
from slam_tricks_tpu_torch.sim.calib_scene import (  # noqa: F401
    CalibScene,
    make_calib_scene,
)
from slam_tricks_tpu_torch.sim.distortion import (  # noqa: F401
    LidarSweep,
    box_segments,
    lidar_sweep,
    ray_segment_intersection,
    rolling_shutter_points,
)
from slam_tricks_tpu_torch.sim.trajectory import (  # noqa: F401
    PoseGraphProblem,
    make_pose_graph,
    spiral_poses,
)
from slam_tricks_tpu_torch.sim.two_view import (  # noqa: F401
    TwoViewScene,
    make_two_view,
)
