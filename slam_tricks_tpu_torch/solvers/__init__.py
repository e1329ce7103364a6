"""Solver layer: the slot-major Schur-complement BA solver (paths A and G),
the banded trajectory solver (path B), the loop-closure solver (path L),
the incremental smoother on the banded layout (path I), the
observation-list reference solver and its PCG (paths O and D), the flat
layout and its PCG (paths F and P), the sliding-window smoother (path W),
the posterior covariances (path V), the pose graphs: dense SE(3)
(path Q), chain (path T), relative-state (path R) and Sim(3) (path S),
the generic Levenberg-Marquardt solver over a manifold (``lm``, which
the dense VI smoother, VI bundle adjustment and Zhang calibration run),
the generic Gauss-Newton solver, one problem or a batch (``gn``), and the
batched analytic-Jacobian PnP (``pnp``)."""

from slam_tricks_tpu_torch.solvers.banded_flat import (  # noqa: F401
    BandedWork,
    TridiagFactor,
    banded_covariances,
    banded_pose_covariances,
    block_tridiag_factor,
    block_tridiag_solve,
    block_tridiag_factor_extend,
    build_banded_work,
    solve_ba_banded,
    tridiag_backward,
    tridiag_forward,
)
from slam_tricks_tpu_torch.solvers.common import SolveResult  # noqa: F401
from slam_tricks_tpu_torch.solvers.gn import (  # noqa: F401
    gauss_newton,
    gauss_newton_batched,
)
from slam_tricks_tpu_torch.solvers.covariance import (  # noqa: F401
    ba_covariances,
)
from slam_tricks_tpu_torch.solvers.incremental import (  # noqa: F401
    IncrementalState,
    active_weight,
    gn_step_stored,
    scatter_points,
    smoother_arrive,
    smoother_init,
)
from slam_tricks_tpu_torch.solvers.lm import levenberg_marquardt  # noqa: F401
from slam_tricks_tpu_torch.solvers.loop_flat import (  # noqa: F401
    LoopWork,
    build_loop_work,
    loop_pose_covariances,
    solve_ba_loop,
)
from slam_tricks_tpu_torch.solvers.pnp import (  # noqa: F401
    PnPResult,
    solve_pnp,
    solve_pnp_batched,
)
from slam_tricks_tpu_torch.solvers.pcg import (  # noqa: F401
    BandPairs,
    build_band_pairs,
    solve_rcs_pcg,
)
from slam_tricks_tpu_torch.solvers.pcg_flat import (  # noqa: F401
    PCGWork,
    build_pcg_work,
    solve_rcs_pcg_flat,
)
from slam_tricks_tpu_torch.solvers.posegraph import (  # noqa: F401
    ChainGraphWork,
    PoseGraphState,
    build_chain_work,
    solve_pose_graph,
    solve_pose_graph_chain,
    solve_pose_graph_relative,
)
from slam_tricks_tpu_torch.solvers.posegraph_sim3 import (  # noqa: F401
    Sim3GraphState,
    solve_pose_graph_sim3,
)
from slam_tricks_tpu_torch.solvers.schur import (  # noqa: F401
    TrackPairs,
    build_track_pairs,
    build_track_table,
    solve_ba,
)
from slam_tricks_tpu_torch.solvers.schur_flat import (  # noqa: F401
    FlatWork,
    build_flat_work,
    grid_order_obs,
    solve_ba_flat,
)
from slam_tricks_tpu_torch.solvers.schur_flat_sm import (  # noqa: F401
    SlotWork,
    build_slot_work,
    solve_ba_flat_sm,
)
from slam_tricks_tpu_torch.solvers.sliding_window import (  # noqa: F401
    WindowPrior,
    empty_prior,
    marginalize,
    run_sliding_window,
    solve_window,
)
