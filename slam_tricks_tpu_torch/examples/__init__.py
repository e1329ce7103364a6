"""The example programs (port of the JAX package's ``examples/*.py``), each
run as ``python -m slam_tricks_tpu_torch.examples.<name> [--cpu] ...``:
ba_demo, calibration_demo, incremental_demo, kitti_vo_demo, pnp_demo,
sim3_posegraph_demo, trajectory_ba_demo, two_view_demo, vi_smoother_demo.

Each keeps its JAX counterpart's flow, arguments, logger name, log lines and
prints, and has ``run(args) -> dict`` (the work, returning the numbers it
logs) and ``main(argv=None)`` (parses the arguments, calls ``run``, writes
what the JAX example writes and returns the dict). Every example runs on the
CUDA device unless ``--cpu`` is given; without ``--cpu`` on a machine with no
CUDA device it fails. ``--cpu`` selects the dtype the JAX example's ``--cpu``
selects.
"""

import torch

from slam_tricks_tpu_torch.solvers.common import set_full_precision


def example_device(cpu):
    """The device of an example: the CPU with ``--cpu``, else the CUDA
    device, with float32 products in full float32 (TF32 off); raises
    RuntimeError without one (no fallback to the CPU)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("this example runs on a CUDA device, and none is "
                           "present: pass --cpu to run it on the CPU")
    set_full_precision()
    return torch.device("cuda")
