"""Solver layer: the slot-major Schur-complement BA solver and the banded
trajectory solver."""

from slam_tricks_tpu_torch.solvers.banded_flat import (  # noqa: F401
    BandedWork,
    build_banded_work,
    solve_ba_banded,
)
from slam_tricks_tpu_torch.solvers.schur_flat_sm import (  # noqa: F401
    SlotWork,
    build_slot_work,
    solve_ba_flat_sm,
)
