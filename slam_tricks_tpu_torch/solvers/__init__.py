"""Solver layer: the slot-major Schur-complement BA solver (path A), the
banded trajectory solver (path B), the loop-closure solver (path L) and the
incremental smoother on the banded layout (path I)."""

from slam_tricks_tpu_torch.solvers.banded_flat import (  # noqa: F401
    BandedWork,
    TridiagFactor,
    banded_covariances,
    banded_pose_covariances,
    block_tridiag_factor,
    block_tridiag_factor_extend,
    build_banded_work,
    solve_ba_banded,
    tridiag_backward,
    tridiag_forward,
)
from slam_tricks_tpu_torch.solvers.incremental import (  # noqa: F401
    IncrementalState,
    active_weight,
    gn_step_stored,
    scatter_points,
    smoother_arrive,
    smoother_init,
)
from slam_tricks_tpu_torch.solvers.loop_flat import (  # noqa: F401
    LoopWork,
    build_loop_work,
    loop_pose_covariances,
    solve_ba_loop,
)
from slam_tricks_tpu_torch.solvers.schur_flat_sm import (  # noqa: F401
    SlotWork,
    build_slot_work,
    solve_ba_flat_sm,
)
