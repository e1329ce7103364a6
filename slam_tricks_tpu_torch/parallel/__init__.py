"""Distributed solvers (port of ``slam_tricks_tpu/parallel``): the
observations or the landmark chunks split over the ranks of a
``torch.distributed`` process group, one process a rank, the normal
equations' camera side summed over the ranks by ``all_reduce``
(``solvers.common.psum``, where the JAX package runs ``shard_map`` and
``psum`` over a mesh axis), and the trust-region control replicated, so
that every rank takes the same steps as the single-process solver."""

from slam_tricks_tpu_torch.parallel.partition import (  # noqa: F401
    build_local_pairs,
    partition_obs_by_landmark,
)
from slam_tricks_tpu_torch.parallel.sharded_ba import (  # noqa: F401
    make_ba_solver,
    pad_obs_to_multiple,
)
from slam_tricks_tpu_torch.parallel.loop_dist import (  # noqa: F401
    build_dist_loop_work,
    make_ba_solver_loop_dist,
)
