"""slam_tricks_tpu_torch — the PyTorch / CUDA port of ``slam_tricks_tpu``.

The JAX package beside it is the reference: each module here mirrors the
module of the same path there and is tested against it on the CPU. The port
imports torch and numpy only, never jax.

The paths ported so far: A, the headline bundle adjustment
(``solvers.schur_flat_sm``, also at large C: G); B, the large-C trajectory
bundle adjustment (``solvers.banded_flat``); L, the same with loop closures
(``solvers.loop_flat``); I, the incremental smoother on B's layout
(``solvers.incremental``); O and D, the observation-list reference solver
(``solvers.schur.solve_ba``: dense, paired, PCG, and tracks, which runs
the dense solve here); F and P, the flat
layout (``solvers.schur_flat``, dense and PCG); W, the sliding-window
smoother (``solvers.sliding_window``); V, posterior covariances
(``solvers.covariance``); E, the st1 undistortion
(``residuals.camera.undistort_points_fast``); the pose graphs: Q, the
dense SE(3) solve (``solvers.posegraph.solve_pose_graph``), T, the chain
solver (``solve_pose_graph_chain``), R, the relative-state solver
(``solve_pose_graph_relative``), and S, the Sim(3) scale-drift graph
(``solvers.posegraph_sim3.solve_pose_graph_sim3``); the inertial slice: J,
IMU preintegration (``estimation.preintegrate``), K, the chain VI smoother
(``estimation.solve_vi_chain``, ``vi_chain_covariances``), the dense VI
smoother (``solve_vi_smoother``, held to K at 64 keyframes: K64) and N,
visual-inertial bundle adjustment (``solve_vi_ba``), both through the
generic LM solver (``solvers.lm``), and U, the visual-inertial
initializer, the SE(3) ESKF and the strapdown INS (``vi_initialize``,
``filter_trajectory``, ``mechanize_trajectory``); the geometric slice: Z,
Zhang calibration (``pipelines.calibration.calibrate``), X, the two-view
pipeline (``pipelines.solve_two_view``), M, batched PnP
(``solvers.solve_pnp_batched``), H, ICP (``residuals.icp.icp_iterate``),
Y, the generic Newton undistortion (``residuals.undistort_points_gn``),
and RS, RANSAC and robust epipolar estimation (``initialization``); the
image front end (FO, SD, LK, DA, ORB, CB, PAN); the host utilities and
the example programs (paths ex_*); and the distributed solvers
(``parallel``, paths dist_*).

- ``manifolds``  SO(2), SE(2), SO(3), SE(3) and Sim(3), batched over
                 leading dimensions, and the manifold combinators
- ``sim``        the st20 cube-room, trajectory and loop-closure scenes,
                 the spiral pose graph, the calibration board and the
                 two-view scene (numpy core, torch tensors out, on the
                 card unless ``device="cpu"``)
- ``estimation`` IMU preintegration, the chain and dense VI smoothers,
                 VI bundle adjustment, the VI initializer, the ESKF and
                 the INS (st4, st14, st23)
- ``solvers``    ``schur_flat_sm.solve_ba_flat_sm``,
                 ``banded_flat.solve_ba_banded`` (with the stored
                 block-tridiagonal factor and the banded covariances),
                 ``loop_flat.solve_ba_loop`` (LM with Schur elimination),
                 ``incremental.smoother_init`` / ``smoother_arrive``,
                 ``schur.solve_ba`` with ``pcg``, ``schur_flat.solve_ba_flat``
                 with ``pcg_flat``, ``covariance.ba_covariances``,
                 ``sliding_window.run_sliding_window``, the pose-graph
                 LM solvers of ``posegraph`` and ``posegraph_sim3``,
                 ``lm.levenberg_marquardt`` over any manifold,
                 ``gn.gauss_newton`` (one problem or a batch) and the
                 batched analytic-Jacobian ``pnp``
- ``initialization`` the 8-point F / E and pose recovery, the DLT
                 homography, N-view triangulation, batched RANSAC,
                 robust epipolar estimation, Zhang's closed form
- ``pipelines``  Zhang calibration and the two-view pipeline
- ``residuals``  ``camera``: pinhole intrinsics, radial-tangential
                 distortion; ``robust``: the robust losses of ``loss=``;
                 ``posegraph``: the relative SE(3) and Sim(3) factors;
                 ``reprojection``: residuals and analytic Jacobians;
                 ``icp``: point residuals, nearest neighbours, alignment,
                 the ICP loop; ``epipolar``, ``calib``, ``simple``
- ``evaluation`` ``metrics``: ATE, trajectory alignment, reprojection RMS
- ``ops``        ``smallchol`` (unrolled 3x3 / 6x6 Cholesky, plain torch) and
                 the hand-written CUDA kernels and their plain torch versions:
                 ``ba_assemble`` (linearize + assemble), ``spd_solve``
                 (reduced camera system), ``tridiag_solve`` (block-tridiagonal
                 systems, one or many right-hand sides), ``undistort``
                 (Newton undistortion)
- ``parallel``   the distributed BA solvers over a ``torch.distributed``
                 process group, one process a rank (observation-sharded,
                 landmark-local, banded, loop-closure, PCG), the landmark
                 partition and the group's set-up (``multihost``)
- ``interop``    numpy / JAX-package state -> the port's tensors (also the
                 preintegrated segments, the VI simulation, the ESKF and
                 INS states, the calibration and two-view scenes, and a
                 checkpoint file the JAX package wrote)
- ``config``     frozen solver, BA and RANSAC settings, dict round trips
- ``utils``      the leveled logger, timers and the torch.profiler trace
                 (each waiting for the CUDA device of its tensors),
                 checkpoints of nests of tensors, corner files and the
                 TUM / EuRoC / KITTI readers (host numpy)
- ``viz``        the Hessian sparsity image, trajectory and scene plots
                 (matplotlib, imported when a plot is drawn), CSV export
- ``examples``   the nine example programs of the JAX package's
                 ``examples/``, each ``python -m
                 slam_tricks_tpu_torch.examples.<name> [--cpu]``: on the
                 card unless given ``--cpu``

Importing the package needs neither CUDA nor ``nvcc``: the kernels are built
with ``nvcc`` at their first launch on a CUDA tensor (``ops/_build.py``).
"""

__version__ = "0.1.0"
