"""Smoke run of the torch port (slam_tricks_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

From the root of a checkout: builds the CUDA kernels from the sources in
slam_tricks_tpu_torch/csrc, holds each against its plain torch version at the
shapes of the paths that run it (and tridiag_solve also at the widest band's
(16, 192), its global-tile instance; ba_assemble also with each robust loss,
huber, cauchy, tukey and the chi-square gate, at paths A's and B's shapes),
holds two launches of ba_assemble against each other bitwise, checks that
spd_solve returns NaN on a matrix that is not positive definite, as its
plain version does, checks small float64 solves through the kernels against
the CPU path (paths A, B, L and I), then drives the port's paths
through the kernels, each with every launch count set to 0 just before it:

- A, the headline bundle adjustment (st20 cube room: 96 cameras, 2400
  landmarks, 83,338 observations, 20 LM iterations, float32, TF32 off,
  spd_solve at n = 576, none of its calls on the large-n kernel), and
  again, which must give the same bits;
- B, the large-C trajectory bundle adjustment (1024 cameras, 200,000
  landmarks, tracks of 8, 1,600,000 observations, 12 LM iterations, float32,
  TF32 off), whose reduced camera system is block-tridiagonal, and again,
  which must give the same bits;
- L, the loop-closure bundle adjustment (bench.py's loop_scale: 1024
  cameras, 200,000 landmarks, tracks of 8, 1543 of them seen again by the
  last 8 cameras, max_band 8, 12 LM iterations, float32): the banded
  system's stored factor with a Woodbury correction of width 144;
- I, the incremental smoother on path B's scene: a start on 512 cameras,
  then 8 arrivals of 64 cameras up to 1024, 2 Gauss-Newton steps each,
  float32;
- O, schur.solve_ba on path A's scene, 20 LM iterations, with the dense
  reduced camera system (spd_solve) and with block-Jacobi PCG (no kernel);
- F, schur_flat.solve_ba_flat (dense) on path A's scene, 20 iterations,
  its first accepted step's cost held to path A's; and V, the posterior
  covariances at F's state;
- D, schur.solve_ba "paired", the exact dense comparator, on path B's
  scene (about 7.2 M within-track pairs, S of n = 6144), 5 iterations,
  every spd_solve call on the large-n kernel (spd_solve.BLOCKED_CALLS);
- P, schur_flat.solve_ba_flat "pcg" on path B's scene, 5 iterations;
- W, the sliding-window smoother on path B's scene (windows of 24 cameras,
  shift 12, 8 anchors, 15 iterations a window), in float32 and float64,
  each window's cost non-negative and no higher than its start, the ATE
  below the perturbed start's, the float64 sweep on the truth up to a
  similarity and the float32 one near it; both kernels against plain at
  the shapes of a window with a prior, in both types; ba_assemble also
  against plain at path P's grid;
- G, schur_flat_sm at large C (1024 cameras, 7200 landmarks, K = 464
  slots a landmark), 12 iterations, and again, which must give the same
  bits; spd_solve at n = 6144 (paths D's and G's systems, the large-n
  kernel) against plain;
- V on 20- and 64-camera trajectories in float64: the dense covariances
  against banded_flat's (gated on 20 cameras, reported on 64);
- the pose graphs, each twice where it must give the same bits: Q, the
  dense SE(3) solve (make_pose_graph(n=40, odo_noise=0.03,
  meas_noise=0.003, seed=2), 50 iterations, float32 and float64, n =
  240); T, the chain solver (the 2048-pose circle graph with 16 loops,
  seed 1, float64, 20 iterations, a capacitance of q = 96); R, the
  relative-state solver, on the same graph in float32 (held to T) and on
  bench.py's 10,000-pose graph (64 loops, seed 17, made in float32 as the
  bench makes it, 80 iterations, q = 384); S, the Sim(3) scale-drift graph of bench.py (96 keyframes, 6
  loops, float32, 40 iterations, n = 672); spd_solve against plain on
  each path's first system in float32 and float64;
- the inertial paths, after tridiag_solve with many right-hand sides
  against plain at (G, m, q) = (1024, 9, 7), (1024, 9, 6) and (1023, 9, 7)
  in float32 and float64 (and path B's single right-hand side as a 3-D r,
  bitwise the 2-D answer): J, IMU preintegration of 3072 segments x 64
  samples (float32; the truth's residual on a zero-noise float64 stream of
  that size below 1e-6); K, the chain VI smoother solve_vi_chain on 1024
  keyframes (float32, 25 iterations, one tridiag_solve of q = 7 an
  iteration; ATE below 0.4 x the observations', the bias within 0.02,
  the same bits twice) and its covariances (q = 6; every block symmetric
  positive definite); K64, the chain against the dense smoother on 64
  keyframes in float64 (spd_solve at n = 582; cost and poses within
  1e-8); N, visual-inertial bundle adjustment on 12 keyframes and 60
  landmarks from a 0.7x-scaled start (float64, spd_solve at n = 294;
  scale within 0.03 of 1); U, vi_initialize, the ESKF over 80 steps and
  the INS over 6000 (float64, no kernel, the JAX tests' gates);
- the geometric-vision paths: Z, Zhang calibration (bench.py's 9-view
  board, noise 0.3, seed 7, float32: the closed-form start and 30 LM
  iterations on the card, n = 63, through spd_solve; the JAX tests' float64
  scenes with their gates); X, the two-view pipeline (2000 points, noise
  1e-3, seed 8, float32, 15 refinement iterations through ba_assemble at
  (K 2, L 2000) and spd_solve at n = 12, and the start alone); M, batched
  PnP (8192 problems x 32 points, 10 iterations, float32); H, SE(3) ICP
  (8192 points, 10 sweeps, float32); Y, the generic Newton undistortion
  of 65,536 float32 pixels held to the undistort kernel; RS, RANSAC on the
  50%-outlier parabola and robust_fundamental on 80 matches with 20
  corrupted (float64, generators on the card); spd_solve against plain at
  n = 63 and 12 in float32 and float64, ba_assemble at X's grid;
- the image front end on 640 x 480 float32 frames made from a seed with
  numpy and scipy, each held to the same port function on the CPU in
  float64 and to the JAX tests' gates: FO, gaussian_blur (sigma 1.5),
  sobel, top_k_peaks (k 1000, r 4) and undistort_image (path E's
  coefficients); SD, rolling_shutter_points (4096 points) and lidar_sweep
  (1440 beams) in box_segments; LK, lk_track (3 levels, win 7, 15
  iterations, 1024 seeds) on a (3.4, -2.2) px shift; DA,
  direct_pose_estimate (k 2048, 40 LM iterations); ORB, orb_detect (n
  1000) on two frames 30 degrees apart and orb_match; CB,
  detect_chessboard on a rendered board of 7 x 9 interior corners; PAN,
  stitch of three overlapping crops with Harris and with ORB features;
- the example programs (slam_tricks_tpu_torch.examples) at their default
  sizes, float32 on the card, through their run(): ex_ba (30 cameras,
  spd_solve at n = 180), ex_calibration (9 views, n = 63), ex_incremental
  (64 cameras, ba_assemble and tridiag_solve), ex_pnp (no kernel),
  ex_sim3 (96 keyframes, n = 672 and 576), ex_trajectory (512 cameras,
  50,000 landmarks, tukey(0.02): ba_assemble and tridiag_solve),
  ex_two_view and ex_vi, each gated on its own outcome; ex_ba,
  ex_calibration, ex_pnp, ex_two_view, ex_sim3 and ex_vi also on the CPU
  and held to it; ba_assemble at ex_trajectory's grid with its loss held
  to plain in float64; the host utilities on the card (a profiler trace
  naming an annotate region, ex_ba's BAState through a checkpoint, the
  same bits, and Timer.lap against CUDA events);
- the distributed solvers (slam_tricks_tpu_torch.parallel) on two gloo
  ranks, spawned processes that share the card, each path beside its
  single-process path of this run (the same iteration count, the first
  accepted step's cost within a stated f32 tolerance, its final-cost
  gate) and the ranks' final poses, points and costs bitwise equal:
  dist_banded (B's scene, 12 iterations), dist_loop (L's), dist_pcg (B's
  scene, P's 5 iterations and CG settings), dist_sharded and dist_lmlocal
  (A's scene, 20 iterations, spd_solve replicated at n = 576); every
  kernel of a path launched on every rank, each rank's all_reduce calls
  and bytes an LM iteration counted on rank 0 and the largest operand
  held to the JAX tests' pose-sized caps; ba_assemble against plain at
  every grid the ranks give it (rank 0's slice of B's grid, of L's
  single-run grid and its landmark-local flat grid of dist_pcg, the
  cameras without a slot exact zeros) and at a pad-heavy slice,
  spd_solve at dist_sharded's replicated system;
- BAL, Dubrovnik-356's generated photo collection at the dubrovnik-solve
  cell's configuration and start (benchmark/configs/bal_dubrovnik_356.json:
  356 cameras with f, k1, k2, 226,730 landmarks, 1,255,268 observations in
  power-of-two track-length buckets, float32): ba_assemble's 9-wide
  kernel over every bucket grid against the grids' plain version, two
  launches bitwise; spd_solve at n = 3,204 on the start's Jacobi-scaled
  reduced camera system (the large-n kernel) against plain and the
  library; schur_bal.solve_bal, 10 LM iterations through the CUDA graphs,
  every spd_solve call on the large-n kernel, under the cell's gate, and
  again, which must give the same bits;
- E, the st1 undistortion of 8,388,608 float32 pixels, 5 Newton steps
  (before it, the undistort kernel against plain at its edges: a pointer
  8 mod 16 bytes, odd counts below one block, n = 0, 0, 1 and 8 steps,
  float64);

and checks what each returns. Prints one line per phase, then a JSON line
with each kernel's launches, error, times (CUDA events, median of rounds:
`ms`, `plain_ms` and `library_ms` back to back, host included, as in every
earlier run; `device_ms` on the card alone, its calls queued behind a head
start of matrix products) and bound, each phase's ms per LM iteration,
iterations, final cost and launches, the card's name and power limit from
nvidia-smi, and last the JSON status line. With --profile DIR it also writes
torch.profiler tables of paths A, B, L, D, G, R and K to DIR. Paths M, H,
Y, RS, the front end's and ex_pnp run no kernel.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. Imports nothing of JAX.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# acceptance bounds
ASSEMBLE_REL_TOL = 1e-4     # per output, max |k - p| / max |p|: f32 sums in
#                             another fixed order than plain's index_add_
ASSEMBLE_REL_TOL_F64 = 1e-9     # the same in f64
ASSEMBLE_F64_FACTOR = 10.0  # where f32's own rounding moves an output by more
ASSEMBLE_F64_EPS = 1e-6     # (X's start, ex_trajectory's tukey grid): the
#                             kernel's error off plain in f64 <= this x
#                             plain's + this x the largest value
SPD_RES_FACTOR = 10.0       # kernel residual <= this x the plain one (+ eps)
SPD_RES_EPS = 1e-6          # (the eps: f32; 1e-14 in f64)
SPD_RANDOM_REL_TOL = 5e-6   # x vs plain x on a well-conditioned SPD matrix
TRI_RES_FACTOR = 10.0       # tridiag residual <= this x the plain one (+ eps)
TRI_RANDOM_REL_TOL = 1e-4   # x vs plain x on the well-conditioned system
FINAL_COST_MAX = 0.05       # both known basins (~1e-10, ~2.5e-2) are below
B_FINAL_COST_MAX = 1e-4     # path B starts at ~1e2 (102.4 on the card); L too
I_RMS_MAX = 1e-4            # path I's RMS reprojection error at its end,
#                             normalized units (0.05 px at f = 458): the
#                             stream freezes the prefix and takes 2 steps an
#                             arrival, so its cost stays above the batch
#                             optimum's (as the JAX package's stream does)
LOOP_STRUCTURE = (1543, 23, 144)   # loop landmarks, support cameras, width
#                                    (bench.py:1087-1093's counts, JAX run)
SMALL_POSE_TOL = 1e-8       # f64 small-scene poses, card vs CPU
FA_REL_TOL = 1e-4           # path F's first accepted cost vs path A's (the
#                             same math, f32 sums in another order)
D_FINAL_COST_MAX = 1e-5     # paths D and P after 5 iterations from 102.4
P_FINAL_COST_MAX = 1e-5     # (the JAX package on a TPU: 3.7e-7 and 1.2e-6)
G_FINAL_COST_MAX = 1e-6     # path G after 12 (JAX on a TPU: 7.6e-9 after 9)
W_F64_ALIGNED_MAX = 1e-6    # path W f64: ATE after the similarity alignment
#                             (noiseless data: the sweep is exact up to the
#                             free scale; tools/sweep_precision.py at full
#                             size: 9.3e-13 on the CPU, 1.6e-12 on an H100)
W_F32_VS_F64_MAX = 0.02     # path W f32 against f64 after the similarity
#                             alignment: f32's scale drift (the same tool:
#                             5.3e-3 and 1.06e-2 on the CPU with 6 and 4
#                             threads; the start's ATE is 0.0172)
COV_SYM_TOL = 1e-3          # covariance blocks: max |P - Pᵀ| / max |P|
COV_PSD_TOL = 1e-4          # and their least eigenvalue >= -this x largest
V_POSE_RTOL, V_POSE_ATOL = 1e-5, 1e-8   # banded vs dense covariances, f64:
V_LM_RTOL, V_LM_ATOL = 1e-4, 1e-7       # tests/test_banded_flat.py:132-190
UNDISTORT_TOL = 2.5e-4      # px, kernel vs plain, f32 (a few ulp at 700 px)
UNDISTORT_F64_TOL = 1e-9    # px, kernel vs plain, f64
ROUND_TRIP_TOL = 1e-3       # px, |undistort(distort(px)) - px|, f32

# peaks of one H100 SXM (NVIDIA's data sheet): the bound of each kernel,
# all of which run outside the tensor cores here, in float32 (float64 on
# path W's f64 sweep)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _time_ms(fn, rounds=5, reps=10, head_start=False):
    """Per-call time of fn in ms: CUDA events around `reps` calls, median
    over `rounds` (after one warm-up call). Back to back, the events time
    whichever is slower, the card or the host queuing the calls. With
    head_start, each round queues its calls behind ~60 ms of matrix
    products, so that the host has queued them all before the card reaches
    the first: the events then time the card alone (checked: the start
    event must not have run when the last call is queued)."""
    import torch

    fn()
    torch.cuda.synchronize()
    busy = torch.ones((8192, 8192), device="cuda") if head_start else None
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if head_start:
            for _ in range(3):
                busy @ busy
        start.record()
        for _ in range(reps):
            fn()
        if head_start and start.query():
            raise AssertionError("head start too short: the card reached the "
                                 "timed calls before the host queued them")
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _paired_ms(kernel, plain, **kw):
    """(kernel ms, plain ms, kernel device ms): the first two back to back,
    taken in turns (plain, kernel, kernel, plain), the last queued behind a
    head start."""
    p1, k1, k2, p2 = (_time_ms(f, **kw) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2, _time_ms(kernel, head_start=True, **kw)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, flops, f64=False):
    """The least time in ms the card could take: bytes over the memory rate
    or float32 (with f64, float64) operations over the peak rate, whichever
    is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _reset_counts(*mods):
    for mod in mods:
        mod.LAUNCHES = 0


def _check_costs(c, max_final, label):
    if not all(v == v and abs(v) != float("inf") for v in c):
        raise AssertionError(f"{label}: non-finite cost: {c}")
    if any(b > a for a, b in zip(c, c[1:])):
        raise AssertionError(f"{label}: cost increased: {c}")
    if not c[-1] < max_final:
        raise AssertionError(f"{label}: final cost {c[-1]} >= {max_final}")


def check_same_bits(one, two, label):
    """Two solves of one problem must give the same bits in the final cost,
    every pose field and, where the state has them, the points."""
    import torch

    fields = [("cost", one.cost, two.cost),
              *zip(one.poses._fields, one.poses, two.poses)]
    if hasattr(one, "points"):
        fields.append(("points", one.points, two.points))
    for name, a, b in fields:
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: two runs differ in the {name}")
    _log(label, f"a second run: the same bits in the cost ({float(two.cost)!r}"
                f") and {', '.join(name for name, *_ in fields[1:])}")


def _shape_key(args):
    """The shapes and dtypes of the tensors among a call's arguments."""
    return tuple((tuple(x.shape), str(x.dtype)) for x in args
                 if hasattr(x, "shape"))


def captured_calls(targets, fn, per_shape=None, counts=None):
    """Runs fn with each (module, name) of `targets` (a kernel wrapper that
    a solver module imported) wrapped: for each, the list of the arguments
    of its calls, their first five tensors copied (the rest, a layout's
    w, cam_of_slot and camera index, are the layout's own, unchanged).
    With `per_shape`, only the first `per_shape` calls at each _shape_key
    are kept; `counts`, a dict, gets {target: {shape key: calls}}. Returns
    fn's result last."""
    import torch

    got, real = {t: [] for t in targets}, {}
    seen = {} if counts is None else counts
    seen.update({t: {} for t in targets})

    def wrap(key, f):
        def call(*a, **kw):
            shapes = _shape_key(a)
            n = seen[key].get(shapes, 0)
            seen[key][shapes] = n + 1
            if per_shape is None or n < per_shape:
                got[key].append(tuple(
                    x.clone() if i < 5 and isinstance(x, torch.Tensor) else x
                    for i, x in enumerate(a)))
            return f(*a, **kw)
        return call

    for mod, name in targets:
        real[(mod, name)] = getattr(mod, name)
        setattr(mod, name, wrap((mod, name), real[(mod, name)]))
    try:
        out = fn()
    finally:
        for (mod, name), f in real.items():
            setattr(mod, name, f)
    return [*(got[t] for t in targets), out]


def check_covariances(pose_cov, point_cov, fixed, obs, label):
    """Pose and landmark covariance blocks finite, symmetric and positive
    semi-definite (COV_SYM_TOL, COV_PSD_TOL); the fixed cameras' zero."""
    import torch

    if float(pose_cov[fixed].abs().max()) != 0.0:
        raise AssertionError(f"{label}: a fixed camera's covariance is not 0")
    observed = torch.zeros(point_cov.shape[0], dtype=torch.bool,
                           device=point_cov.device)
    observed[obs.lm_idx[obs.weight > 0].long()] = True
    worst = {}
    for name, blk in (("pose", pose_cov[~fixed]),
                      ("landmark", point_cov[observed])):
        if not torch.isfinite(blk).all():
            raise AssertionError(f"{label}: non-finite {name} covariance")
        scale = blk.abs().amax(dim=(1, 2))
        asym = float(((blk - blk.mT).abs().amax(dim=(1, 2)) / scale).max())
        eig = torch.linalg.eigvalsh((0.5 * (blk + blk.mT)).double())
        neg = float((-eig[:, 0] / eig[:, -1]).max())
        worst[name] = (asym, neg)
        if not (asym <= COV_SYM_TOL and neg <= COV_PSD_TOL):
            raise AssertionError(f"{label}: {name} blocks asymmetry {asym}, "
                                 f"least / largest eigenvalue {-neg}")
    _log(label, f"{int((~fixed).sum())} pose and {int(observed.sum())} "
                f"landmark blocks: max asymmetry / least eigenvalue ratio "
                f"poses {worst['pose'][0]:.2e} / {-worst['pose'][1]:.2e}, "
                f"landmarks {worst['landmark'][0]:.2e} / "
                f"{-worst['landmark'][1]:.2e}; fixed cameras zero")


def covariance_err(a, b, rtol, atol):
    """The worst |a - b| / (atol max|b| + rtol |b|): <= 1 passes
    numpy.testing.assert_allclose(a, b, rtol, atol max|b|)."""
    bound = atol * b.abs().max() + rtol * b.abs()
    return float(((a - b).abs() / bound).max())


def _profile(fn, path, label):
    """torch.profiler table (CUDA time by kernel) of one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path.write_text(table)
    _log("profile", f"{label}: {path}")


# ---- slice C: the pose graphs (paths Q, T, R and S) ----

PG_Q = dict(n=40, odo_noise=0.03, meas_noise=0.003, seed=2)   # tests/
#                             test_posegraph_calib.py:32, 50 iterations
PG_T = dict(N=2048, n_loops=16, seed=1, odo_noise=0.01, loop_noise=0.001)
#                             tests/test_posegraph_chain.py:146-158, f64
PG_R = dict(N=10_000, n_loops=64, seed=17, odo_noise=0.002,
            loop_noise=0.0005)  # bench.py:1220-1268, f32, up to 80
PG_S = dict(N=96, n_loops=6, ds=0.004, seed=12)   # bench.py:719-771, f32
PG_ATE_RATIO = 0.25         # Q and R: ATE below this x the start's
#                             (tests/test_posegraph_chain.py:113)
PG_R_VS_T_COST_RTOL = 1e-2  # R (f32) against T (f64) at N = 2048, and the
PG_R_VS_T_ATE_REL = 0.01    # ATEs within 1% (test_posegraph_chain.py:164)
PG_S_SCALE_ERR = 0.06       # S: max |s / s_true - 1| and the ATE below
PG_S_ATE_RATIO = 0.2        # 0.2 x the start's (tests/test_sim3.py:223)


def _rmse(t, t_true):
    """The chain tests' and bench's ATE: the RMS over all coordinates."""
    return float(((t.double() - t_true) ** 2).mean().sqrt())


def _dot3(A, B):
    """A @ B over the last two axes (inner size 3), numpy, in A's dtype. A
    float32 product is rounded as XLA rounds it on the CPU, where
    bench.py and tests/test_posegraph_chain.py make their graphs: the first
    product, then two fused multiply-adds (a product of two float32 numbers
    is exact in float64). With torch's unfused float32 products the
    rounding of the measured rotations is biased, and the start, which
    composes them, drifts off orthonormal eight times as far as the
    bench's (tools/posegraph_f32_start.py), where the relative solvers of
    both packages stall."""
    import numpy as np

    if A.dtype == np.float64:
        return A @ B
    A, B = A.astype(np.float64), B.astype(np.float64)
    acc = (A[..., :, 0, None] * B[..., None, 0, :]).astype(np.float32)
    for k in (1, 2):
        acc = (A[..., :, k, None] * B[..., None, k, :] + acc).astype(
            np.float32)
    return acc


def circle_graph(N, n_loops, seed, odo_noise, loop_noise, dtype, device):
    """The circle pose graph of tests/test_posegraph_chain.py::make_graph
    and bench.py:stage_posegraph, made as they make it, on the host: an
    odometry chain and loops from the first to the last quarter; the truth
    and the measurements in `dtype` (numpy's), each measurement the truth
    perturbed by exp(xi), xi drawn from default_rng(seed) in their order;
    the start the odometry integrated in float64 from those measurements
    and cast. A float32 graph matches the JAX package's to within an ulp
    (tests/test_torch_posegraph_relative.py). Returns (true translations
    (N, 3) float64, poses0, i, j, Z, sqrt_info), tensors on `device`."""
    import numpy as np
    import torch

    from slam_tricks_tpu_torch.manifolds import se3, so3

    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(N) / N
    t_true = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                       0.1 * np.sin(3 * ang)], 1)
    Rt = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                             [np.sin(a), np.cos(a), 0],
                             [0, 0, 1]]) for a in ang])
    ii = np.concatenate([np.arange(N - 1), rng.integers(0, N // 4, n_loops)])
    jj = np.concatenate([np.arange(1, N),
                         rng.integers(3 * N // 4, N, n_loops)])
    E = ii.size
    R, t = Rt.astype(dtype), t_true.astype(dtype)
    mv = lambda A, v: _dot3(A, v[..., None])[..., 0]  # noqa: E731
    RiT = np.swapaxes(R[ii], -1, -2)                # Zc = Ti^-1 Tj
    ZcR, Zct = _dot3(RiT, R[jj]), mv(RiT, t[jj]) + -mv(RiT, t[ii])
    scale = np.where(np.arange(E) < N - 1, odo_noise, loop_noise)
    xi = (rng.normal(size=(E, 6)) * scale[:, None]).astype(dtype)
    w = torch.from_numpy(xi[:, 3:])                 # exp(xi), on the host
    ER, Et = so3.exp(w).numpy(), mv(so3.jl(w).numpy(), xi[:, :3])
    ZR, Zt = _dot3(ZcR, ER), mv(ZcR, Et) + Zct     # Z = Zc exp(xi)
    Zr, Zt64 = ZR.astype(np.float64), Zt.astype(np.float64)
    R0, t0 = [Rt[0]], [t_true[0]]
    for k in range(N - 1):
        R0.append(R0[-1] @ Zr[k])
        t0.append(R0[-2] @ Zt64[k] + t0[-1])
    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    info = torch.eye(6, dtype=T(xi).dtype, device=device).expand(E, 6, 6)
    return (T(t_true), se3.SE3(T(np.stack(R0).astype(dtype)),
                               T(np.stack(t0).astype(dtype))),
            T(ii), T(jj), se3.SE3(T(ZR), T(Zt)), info)


def mono_sim3_graph(N, n_loops, ds, seed, device):
    """bench.py:_sim3_pgo's scale-drift graph, f32: a circle whose
    keyframes carry the drifting scale e^{-ds i}, Sim(3) odometry with
    1e-3 noise on all 7 axes, exact loops (information x10), the start the
    odometry's (R, t) integrated with s = 1. Returns (true translations
    (N, 3) float64, true scales (N,) float64, poses0, i, j, Z,
    sqrt_info)."""
    import numpy as np
    import torch

    from slam_tricks_tpu_torch.manifolds import sim3

    r2 = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(N) / N
    tt = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                   0.1 * np.sin(3 * ang)], 1).astype(np.float32)
    Rt = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                             [np.sin(a), np.cos(a), 0],
                             [0, 0, 1]]) for a in ang]).astype(np.float32)
    p = np.exp(-ds * np.arange(N)).astype(np.float32)
    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    gt = sim3.Sim3(T(Rt), T(tt), T(p))
    ii = np.concatenate([np.arange(N - 1), r2.integers(0, N // 4, n_loops)])
    jj = np.concatenate([np.arange(1, N), r2.integers(3 * N // 4, N, n_loops)])
    i_t, j_t = T(ii), T(jj)
    Zc = sim3.mul(sim3.inv(sim3.Sim3(*(a[i_t] for a in gt))),
                  sim3.Sim3(*(a[j_t] for a in gt)))
    xi = (r2.normal(size=(ii.size, 7)) * 1e-3).astype(np.float32)
    xi[N - 1:] = 0.0
    Z = sim3.mul(Zc, sim3.exp(T(xi)))
    info = np.broadcast_to(np.eye(7, dtype=np.float32),
                           (ii.size, 7, 7)).copy()
    info[N - 1:] *= 10.0
    Rz, tz = Z.R.double().cpu().numpy(), Z.t.double().cpu().numpy()
    R0, t0 = [Rt[0].astype(np.float64)], [tt[0].astype(np.float64)]
    for k in range(N - 1):
        t0.append(R0[-1] @ tz[k] + t0[-1])
        R0.append(R0[-1] @ Rz[k])
    poses0 = sim3.Sim3(T(np.stack(R0).astype(np.float32)),
                       T(np.stack(t0).astype(np.float32)),
                       torch.ones(N, dtype=torch.float32, device=device))
    return (T(tt.astype(np.float64)), T(p.astype(np.float64)), poses0, i_t,
            j_t, Z, T(info))


def posegraph_paths(dev, run_phase, check_spd, phases, profile_dir=None):
    """Paths Q, T, R (N = 2048 and the bench's 10,000) and S through the
    port's pose-graph solvers, each run with every launch count set to 0
    just before it (run_phase) and gated; spd_solve held against plain
    (check_spd) on each path's first system, in float32 and float64.
    Returns {label: check_spd's dict}."""
    import numpy as np
    import torch

    from slam_tricks_tpu_torch.evaluation import metrics
    from slam_tricks_tpu_torch.sim import make_pose_graph
    from slam_tricks_tpu_torch.solvers import posegraph, posegraph_sim3

    f32, f64 = torch.float32, torch.float64
    systems, k2 = {}, {}

    def first_system(fn):
        """The (S, b) of the first spd_solve call of fn."""
        calls, _ = captured_calls([(posegraph, "spd_solve")], fn)
        return calls[0]

    def gate_run(label, out, cf, launches, ms, extra):
        """Costs finite and non-increasing, below the start; one spd_solve
        launch an LM iteration; the phase's record."""
        _check_costs(cf, cf[0], label)
        if launches["spd_solve"] != out.it:
            raise AssertionError(f"{label}: {launches['spd_solve']} spd_solve "
                                 f"launches in {out.it} iterations")
        if not all(torch.isfinite(a).all() for a in out.poses):
            raise AssertionError(f"{label} returned non-finite poses")
        phases[label.replace("path ", "").replace(" ", "_")] = {
            "ms_per_lm_iter": ms, "iters": out.it, "final_cost": cf[-1],
            "launches": launches, **extra}

    # ---- Q: the dense SE(3) solve, f32 and f64 (n = 240) ----
    for dtype in (f32, f64):
        name = str(dtype).rsplit(".", 1)[1]
        label = f"path Q {name}"
        prob = make_pose_graph(dtype=dtype, device=dev, **PG_Q)
        solve = lambda costs=None: posegraph.solve_pose_graph(  # noqa: E731
            prob.poses_init, prob.i_idx, prob.j_idx, prob.Z,
            fixed_mask=prob.fixed_mask, max_iters=50, costs=costs)
        out, cf, launches, ms = run_phase(label, solve)
        ate0 = float(metrics.ate_translation_rmse(prob.poses_init,
                                                  prob.poses_true))
        ate = float(metrics.ate_translation_rmse(out.poses, prob.poses_true))
        _log(label, f"40 poses, {prob.i_idx.shape[0]} edges: ATE {ate0:.6e} "
                    f"-> {ate:.6e} (gate < {PG_ATE_RATIO} x start)")
        if not ate < PG_ATE_RATIO * ate0:
            raise AssertionError(f"{label}: ATE {ate} vs start {ate0}")
        gate_run(label, out, cf, launches, ms, {"ate": ate, "ate_start": ate0})
        check_same_bits(out, solve(), label)
        systems.setdefault("Q_n240", {})[dtype] = first_system(
            lambda: posegraph.solve_pose_graph(
                prob.poses_init, prob.i_idx, prob.j_idx, prob.Z,
                fixed_mask=prob.fixed_mask, max_iters=1))

    # ---- T: the chain solver, f64, N = 2048 (q = 96) ----
    t_true, p0, ii, jj, Z, info = circle_graph(dtype=np.float64,
                                               device=dev, **PG_T)
    N = PG_T["N"]
    work64 = posegraph.build_chain_work(ii, jj, Z, info, N, dtype=f64,
                                        device=dev)
    out_t, cf, launches, ms = run_phase(
        "path T", lambda costs: posegraph.solve_pose_graph_chain(
            p0, work64, max_iters=20, costs=costs))
    ate0_t, ate_t = _rmse(p0.t, t_true), _rmse(out_t.poses.t, t_true)
    _log("path T", f"{N} poses, {PG_T['n_loops']} loops (q = "
                   f"{6 * work64.loop_i.shape[0]}): ATE {ate0_t:.6e} -> "
                   f"{ate_t:.6e}; the stored factor a Python loop over "
                   f"{N} blocks an iteration")
    gate_run("path T", out_t, cf, launches, ms,
             {"ate": ate_t, "ate_start": ate0_t})
    systems["T_q96"] = {f64: first_system(
        lambda: posegraph.solve_pose_graph_chain(p0, work64, max_iters=1))}

    # ---- R at N = 2048: T's graph cast to f32, against T, as
    # tests/test_posegraph_chain.py:146-169 holds the two ----
    work32 = posegraph.build_chain_work(ii, jj, Z, info, N, dtype=f32,
                                        device=dev)
    p32 = type(p0)(p0.R.float(), p0.t.float())
    out_r2, cf, launches, ms = run_phase(
        "path R 2048", lambda costs: posegraph.solve_pose_graph_relative(
            p32, work32, max_iters=20, costs=costs))
    ate_r2 = _rmse(out_r2.poses.t, t_true)
    rel = abs(float(out_r2.cost) - float(out_t.cost)) / float(out_t.cost)
    _log("path R 2048", f"f32 cost {float(out_r2.cost):.6e} vs T's f64 "
                        f"{float(out_t.cost):.6e} (rel {rel:.3e}, gate "
                        f"{PG_R_VS_T_COST_RTOL}); ATE {ate_r2:.6e} vs T's "
                        f"{ate_t:.6e}")
    if not (rel <= PG_R_VS_T_COST_RTOL and abs(ate_r2 - ate_t)
            < PG_R_VS_T_ATE_REL * max(ate_t, 0.01)):
        raise AssertionError(f"path R 2048 against T: cost rel {rel}, ATE "
                             f"{ate_r2} vs {ate_t}")
    gate_run("path R 2048", out_r2, cf, launches, ms,
             {"ate": ate_r2, "cost_rel_to_t": rel})
    del work64, work32, out_t, out_r2

    # ---- R: the bench's 10,000-pose graph, made in f32 (q = 384) ----
    t_true, p0, ii, jj, Z, info = circle_graph(dtype=np.float32,
                                               device=dev, **PG_R)
    N = PG_R["N"]
    work = posegraph.build_chain_work(ii, jj, Z, info, N, dtype=f32,
                                      device=dev)
    solve_r = lambda iters, costs=None: (  # noqa: E731
        posegraph.solve_pose_graph_relative(p0, work, max_iters=iters,
                                            costs=costs))
    out, cf, launches, ms = run_phase("path R", lambda costs: solve_r(80,
                                                                      costs))
    ate0, ate = _rmse(p0.t, t_true), _rmse(out.poses.t, t_true)
    _log("path R", f"{N} poses, {PG_R['n_loops']} loops (q = "
                   f"{6 * work.loop_i.shape[0]}): ATE {ate0:.6e} -> {ate:.6e}"
                   f" (gate < {PG_ATE_RATIO} x start)")
    if not ate < PG_ATE_RATIO * ate0:
        raise AssertionError(f"path R: ATE {ate} vs start {ate0}")
    gate_run("path R", out, cf, launches, ms, {"ate": ate, "ate_start": ate0})
    check_same_bits(out, solve_r(80), "path R")
    systems["R_q384"] = {f32: first_system(lambda: solve_r(1))}
    if profile_dir is not None:
        _profile(lambda: solve_r(5), profile_dir / "path_r.txt",
                 "path R, 5 LM iterations")
    del work, out

    # ---- S: the Sim(3) scale-drift graph, f32 (n = 672) ----
    t_true, s_true, p0, ii, jj, Z, info = mono_sim3_graph(device=dev, **PG_S)
    solve_s = lambda iters, costs=None: (  # noqa: E731
        posegraph_sim3.solve_pose_graph_sim3(p0, ii, jj, Z, info,
                                             max_iters=iters, xtol=0.0,
                                             costs=costs))
    out, cf, launches, ms = run_phase("path S", lambda costs: solve_s(40,
                                                                      costs))
    ate_of = lambda t: float(((t.double() - t_true) ** 2).sum(1)  # noqa: E731
                             .mean().sqrt())
    ate0, ate = ate_of(p0.t), ate_of(out.poses.t)
    s_err = float((out.poses.s.double() / s_true - 1.0).abs().max())
    _log("path S", f"{PG_S['N']} keyframes, {PG_S['n_loops']} loops: ATE "
                   f"{ate0:.6e} -> {ate:.6e} (gate < {PG_S_ATE_RATIO} x "
                   f"start), scale error {s_err:.3e} (gate < "
                   f"{PG_S_SCALE_ERR})")
    if not (ate < PG_S_ATE_RATIO * ate0 and s_err < PG_S_SCALE_ERR):
        raise AssertionError(f"path S: ATE {ate} vs {ate0}, scale {s_err}")
    gate_run("path S", out, cf, launches, ms,
             {"ate": ate, "ate_start": ate0, "scale_err": s_err})
    check_same_bits(out, solve_s(40), "path S")
    systems["S_n672"] = {f32: first_system(lambda: solve_s(1))}

    # ---- spd_solve at the four new sizes, in both types: the path's own
    # system, cast where the path ran in the other type ----
    for size, native in systems.items():
        for dtype in (f32, f64):
            S_, b_ = native.get(dtype, next(iter(native.values())))
            label = f"{size}_{str(dtype).rsplit('.', 1)[1]}"
            k2[label] = check_spd(S_.to(dtype).contiguous(),
                                  b_.to(dtype).contiguous(), f"path {label}")
    return k2


# ---- slice D: the inertial paths (J, K, K64, N and U) ----

VI_J = dict(segments=3072, samples=64, dt=0.0025)   # bench.py:1148-1165
VI_K = dict(n_keyframes=1024, samples_per_seg=20, dt=0.005, sigma_g=2e-4,
            sigma_a=2e-3, obs_rot_noise=0.005, obs_trans_noise=0.01, seed=3)
#                             bench.py:1172-1190, f32, 25 iterations
VI_SIG = dict(obs_rot_sigma=0.005, obs_trans_sigma=0.01)
J_ZERO_NOISE_MAX = 1e-6     # J: the truth's residual on the zero-noise
#                             stream (at this size ~1.2e-7 in f64 on the
#                             CPU; tests/test_preintegration.py:37 holds
#                             its smaller stream to 5e-5)
K_ATE_RATIO = 0.4           # K: ATE below this x the observations', the
K_BIAS_ERR = 0.02           # bias within this of the truth
#                             (tests/test_preintegration.py:318-337)
K64_COST_RTOL = 1e-8        # K64: chain against dense, f64
K64_POSE_TOL = 1e-8
N_SCALE_ERR = 0.03          # N: |scale - 1| (tests/test_preintegration.py:
#                             214), the 0.7x-scaled start
U_SCALE_ERR = 1e-4          # U: vi_initialize's scale against 2.3 (:240)
U_ESKF_ATE_RATIO = 0.5      # U: the filter's ATE against the observations'
#                             (tests/test_estimation.py:25)
U_INS_DRIFT_M = 5.0         # U: INS drift in m and the final speed in m/s
U_INS_SPEED = 0.2           # (tests/test_estimation.py:78)
TRI_MANY_SHAPES = ((1024, 9, 7), (1024, 9, 6), (1023, 9, 7))


def _dense_tridiag(D, E):
    """The dense (G m, G m) matrix of the block-tridiagonal (D, E)."""
    import torch

    G, m = D.shape[0], D.shape[1]
    T = torch.zeros((G, m, G, m), dtype=D.dtype, device=D.device)
    gi = torch.arange(G, device=D.device)
    T[gi, :, gi, :] = D
    if G > 1:
        T[gi[:-1] + 1, :, gi[:-1], :] = E
        T[gi[:-1], :, gi[:-1] + 1, :] = E.transpose(1, 2)
    return T.reshape(G * m, G * m)


def check_tridiag_many(D, E, r, label, timed=False):
    """tridiag_solve against plain on r (G, m, q) or (G, m): the residual
    against plain's and, on a random system, x to TRI_RANDOM_REL_TOL (1e-9
    in f64).
    With `timed`, also the kernels line's numbers: ms, device ms, plain ms,
    the library's dense Cholesky solve with q columns, and the bound."""
    import torch

    from slam_tricks_tpu_torch.ops import tridiag_solve

    x_k = tridiag_solve.tridiag_solve(D, E, r)
    x_p = tridiag_solve.tridiag_solve_plain(D, E, r)
    torch.cuda.synchronize()
    G, m = r.shape[:2]
    q = r.shape[2] if r.dim() == 3 else 1
    T64 = _dense_tridiag(D.double(), E.double())
    r64 = r.double().reshape(G * m, q)
    res_k = float((T64 @ x_k.double().reshape(G * m, q) - r64).norm()
                  / r64.norm())
    res_p = float((T64 @ x_p.double().reshape(G * m, q) - r64).norm()
                  / r64.norm())
    f64 = D.dtype == torch.float64
    diff = _rel(x_k, x_p)
    _log("tridiag_solve", f"{label} (G, m, q)=({G}, {m}, {q}) {D.dtype}: "
                          f"|Tx-r|/|r| kernel {res_k:.3e} plain {res_p:.3e}; "
                          f"max|x-x_plain|/max|x_plain| {diff:.3e}")
    eps = 1e-14 if f64 else 1e-6
    if not res_k <= TRI_RES_FACTOR * res_p + eps:
        raise AssertionError(f"tridiag_solve {label}: residual {res_k} > "
                             f"{TRI_RES_FACTOR} x plain {res_p} + {eps}")
    if "random" in label and not diff <= (1e-9 if f64 else TRI_RANDOM_REL_TOL):
        raise AssertionError(f"tridiag_solve {label}: rel diff {diff}")
    out = {"G": G, "m": m, "q": q, "max_abs_err": float((x_k - x_p).abs()
                                                        .max()),
           "residual": res_k, "plain_residual": res_p}
    if not timed:
        return out
    ms, plain_ms, device_ms = _paired_ms(
        lambda: tridiag_solve.tridiag_solve(D, E, r),
        lambda: tridiag_solve.tridiag_solve_plain(D, E, r), reps=3)
    Tdense, rdense = T64.to(D.dtype), r.reshape(G * m, q)
    lib_ms = _time_ms(lambda: torch.cholesky_solve(
        rdense, torch.linalg.cholesky_ex(Tdense)[0]), reps=3)
    bound_ms, by = _bound(_nbytes(D, E, r, r), tridiag_solve.flops(G, m, q),
                          f64)
    _log("tridiag_solve", f"{label}: kernel {ms:.4f} ms a call "
                          f"({device_ms:.4f} ms on the card alone); plain "
                          f"torch {plain_ms:.4f} ms, library (cholesky_ex + "
                          f"cholesky_solve of the dense {G * m}^2 matrix, "
                          f"{q} columns) {lib_ms:.4f} ms, bound "
                          f"{bound_ms:.5f} ms ({by})")
    out.update(ms=ms, plain_ms=plain_ms, device_ms=device_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=by)
    return out


def check_spd_blocks(S, label):
    """Covariance blocks S (..., n, n) finite, symmetric to COV_SYM_TOL and
    positive definite: (max asymmetry, least eigenvalue)."""
    import torch

    eig = torch.linalg.eigvalsh(0.5 * (S + S.mT).double())
    asym = float((S - S.mT).abs().max() / S.abs().max())
    if not (bool(torch.isfinite(S).all()) and asym <= COV_SYM_TOL
            and bool((eig[..., 0] > 0).all())):
        raise AssertionError(f"{label}: not symmetric positive definite "
                             f"(asymmetry {asym}, least eigenvalue "
                             f"{float(eig[..., 0].min())})")
    return asym, float(eig[..., 0].min())


def inertial_paths(dev, run_phase, check_spd, phases, profile_dir=None):
    """Paths J, K, K64, N and U of slice D, each solve run with every launch
    count set to 0 just before it (run_phase) and gated; tridiag_solve held
    against plain with many right-hand sides at path K's shapes before the
    paths, and timed on K's own systems; spd_solve held against plain
    (check_spd) on the first systems of the dense VI smoother (K64,
    n = 582) and of the VI bundle adjustment (N, n = 294). Returns
    {"tridiag": {label: numbers}, "spd": {label: numbers}, "launches":
    {path: {kernel: count}}}. With profile_dir, also writes torch.profiler's
    table of 5 iterations of path K there."""
    import numpy as np
    import torch

    from slam_tricks_tpu_torch.estimation import (eskf, ins, preintegration,
                                                  vi_chain, vi_init,
                                                  vi_smoother)
    from slam_tricks_tpu_torch.evaluation import metrics
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.sim import spiral_poses
    from slam_tricks_tpu_torch.solvers import banded_flat, common

    f32, f64 = torch.float32, torch.float64
    t_start = time.perf_counter()
    tri, spd, launches_of = {}, {}, {}

    # ---- tridiag_solve with many right-hand sides, random systems ----
    rng = np.random.default_rng(9)
    for G, m, q in TRI_MANY_SHAPES:
        A = rng.normal(size=(G, m, m + 3))
        D = A @ A.transpose(0, 2, 1) + m * np.eye(m)[None]
        E = 0.3 * rng.normal(size=(G - 1, m, m))
        r = rng.normal(size=(G, m, q))
        for dtype in (f32, f64):
            T_ = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
            key = f"random_{G}_{m}_{q}_{str(dtype).rsplit('.', 1)[1]}"
            tri[key] = check_tridiag_many(T_(D), T_(E), T_(r),
                                          f"random {key}")

    # ---- J: preintegration of 3072 segments x 64 samples, f32 ----
    nseg, S, dtj = VI_J["segments"], VI_J["samples"], VI_J["dt"]
    simj = vi_smoother.simulate_vi(n_keyframes=8, samples_per_seg=S, dt=dtj,
                                   sigma_g=2e-4, sigma_a=2e-3, dtype=f32,
                                   device=dev)
    gyro = simj.gyro[0].expand(nseg, S, 3).contiguous()
    accel = simj.accel[0].expand(nseg, S, 3).contiguous()
    bz = torch.zeros(3, dtype=f32, device=dev)
    pre_j = preintegration.preintegrate(gyro, accel, dtj, bz, bz)
    ms_j = _time_ms(lambda: preintegration.preintegrate(gyro, accel, dtj, bz,
                                                        bz), rounds=3, reps=2)
    if not all(bool(torch.isfinite(f).all()) for f in pre_j):
        raise AssertionError("path J: non-finite preintegration")
    # gate: the zero-noise f64 stream at the same size, the truth's residual
    sim0 = vi_smoother.simulate_vi(n_keyframes=nseg + 1, samples_per_seg=S,
                                   dt=dtj, device=dev)
    pre0 = vi_smoother.preintegrate_segments(sim0, sim0.bg_true,
                                             sim0.ba_true)
    P0 = sim0.poses_true
    r0 = preintegration.imu_residual(
        pre0, se3.SE3(P0.R[:-1], P0.t[:-1]), sim0.vels_true[:-1],
        se3.SE3(P0.R[1:], P0.t[1:]), sim0.vels_true[1:], sim0.bg_true,
        sim0.ba_true)
    res0 = float(r0.abs().max())
    _log("path J", f"{nseg} segments x {S} samples f32: {ms_j:.3f} ms a "
                   f"call (CUDA events), {nseg / ms_j * 1e3:.4e} segments/s; "
                   f"zero-noise f64 stream of the same size: the truth's "
                   f"largest residual {res0:.3e} (gate <= {J_ZERO_NOISE_MAX})")
    if not res0 <= J_ZERO_NOISE_MAX:
        raise AssertionError(f"path J: zero-noise residual {res0}")
    phases["J"] = {"ms": ms_j, "segments_per_s": nseg / ms_j * 1e3,
                   "segments": nseg, "samples": S,
                   "zero_noise_residual": res0}
    del gyro, accel, pre_j, sim0, pre0, r0

    # ---- K: solve_vi_chain at K = 1024 in f32, 25 iterations ----
    simk = vi_smoother.simulate_vi(dtype=f32, device=dev, **VI_K)
    b0 = torch.zeros(6, dtype=f32, device=dev)
    prek = vi_smoother.preintegrate_segments(simk, b0[:3], b0[3:],
                                             sigma_g=2e-4, sigma_a=2e-3)
    solve_k = lambda iters, costs=None: vi_chain.solve_vi_chain(  # noqa: E731
        prek, simk.obs_poses, simk.obs_poses, simk.vels_true, b0,
        max_iters=iters, costs=costs, **VI_SIG)
    out_k, cf, launches, ms = run_phase("path K", lambda costs: solve_k(
        25, costs))
    ate_obs = float(metrics.ate_translation_rmse(simk.obs_poses,
                                                 simk.poses_true))
    ate_k = float(metrics.ate_translation_rmse(out_k.poses, simk.poses_true))
    bias_true = torch.cat([simk.bg_true, simk.ba_true])
    bias_err = float(torch.linalg.vector_norm(out_k.bias - bias_true))
    _log("path K", f"K = {VI_K['n_keyframes']} f32: ATE {ate_k:.6e} against "
                   f"the observations' {ate_obs:.6e} (gate < {K_ATE_RATIO} x)"
                   f"; |bias - truth| {bias_err:.4e} (gate < {K_BIAS_ERR})")
    _check_costs(cf, cf[0], "path K")
    if launches["tridiag_solve"] != out_k.it or launches["spd_solve"]:
        raise AssertionError(f"path K: launches {launches} in {out_k.it} "
                             f"iterations")
    if not (ate_k < K_ATE_RATIO * ate_obs and bias_err < K_BIAS_ERR):
        raise AssertionError(f"path K: ATE {ate_k} vs {ate_obs}, bias "
                             f"{bias_err}")
    again = solve_k(25)
    check_same_bits(out_k, again, "path K")
    if not torch.equal(out_k.bias, again.bias):
        raise AssertionError("path K: two runs differ in the bias")
    launches_of["K"] = launches
    # the kernel on K's own systems: the first iteration's [-g | U] (q = 7)
    calls, _ = captured_calls([(vi_chain, "block_tridiag_solve")],
                              lambda: solve_k(1))
    tri["path_K_q7"] = check_tridiag_many(*(a.contiguous() for a in calls[0]),
                                          "path K first step", timed=True)

    # covariances at K's state (tridiag_solve with q = 6)
    cov_run = lambda: vi_chain.vi_chain_covariances(  # noqa: E731
        prek, simk.obs_poses, out_k.poses, out_k.vels, out_k.bias, **VI_SIG)
    cov_run()
    (state_cov, bias_cov), _, launches_of["K_cov"], cov_ms = run_phase(
        "path K covariances", lambda costs: cov_run(), iters_of=lambda o: 1)
    asym, least = check_spd_blocks(state_cov, "path K covariances")
    b_asym, b_least = check_spd_blocks(bias_cov, "path K bias covariance")
    _log("path K", f"vi_chain_covariances: {cov_ms:.2f} ms (CUDA events); "
                   f"{state_cov.shape[0]} state blocks 9 x 9 symmetric "
                   f"(max asymmetry {asym:.2e}) and positive definite "
                   f"(least eigenvalue {least:.3e}); bias 6 x 6 asymmetry "
                   f"{b_asym:.2e}, least eigenvalue {b_least:.3e}; launches "
                   f"{launches_of['K_cov']}")
    if launches_of["K_cov"]["tridiag_solve"] != 1:
        raise AssertionError(f"path K covariances: {launches_of['K_cov']}")
    calls, _ = captured_calls([(vi_chain, "block_tridiag_solve")], cov_run)
    tri["path_K_cov_q6"] = check_tridiag_many(
        *(a.contiguous() for a in calls[0]), "path K covariances",
        timed=True)
    # where an iteration's time goes: the linearization (every step of
    # this run is accepted), the cost of the trial state, the solve, and
    # the Takahashi loop of the covariances, each timed alone at K's state
    lin_k, cost_k = vi_chain._system(prek, simk.obs_poses, VI_SIG[
        "obs_rot_sigma"], VI_SIG["obs_trans_sigma"], 1.0,
        preintegration.GRAVITY, "path K")
    x_k = (out_k.poses, out_k.vels, out_k.bias)
    D_k, E_k = lin_k(*x_k)[:2]
    split = {"linearize_ms": _time_ms(lambda: lin_k(*x_k), rounds=3, reps=3),
             "cost_ms": _time_ms(lambda: cost_k(*x_k), rounds=3, reps=3),
             "solve_ms": tri["path_K_q7"]["ms"],
             "takahashi_ms": _time_ms(
                 lambda: banded_flat._takahashi_inverse_blocks(
                     D_k, E_k, D_k.shape[0]), rounds=1, reps=1)}
    split["rest_ms"] = ms - split["linearize_ms"] - split["cost_ms"] - split[
        "solve_ms"]
    _log("path K", "an iteration's parts, each timed alone (CUDA events, "
                   "host included): " + ", ".join(
                       f"{k} {v:.3f}" for k, v in split.items()))
    if profile_dir is not None:
        _profile(lambda: solve_k(5), profile_dir / "path_k.txt",
                 "path K, 5 LM iterations")
    phases["K"] = {"ms_per_lm_iter": ms, "iters": out_k.it,
                   "final_cost": cf[-1], "launches": launches, "ate": ate_k,
                   "ate_obs": ate_obs, "bias_err": bias_err,
                   "covariances_ms": cov_ms, "split": split}
    del simk, prek, out_k, again, state_cov, bias_cov, calls

    # ---- K64: the chain against the dense smoother, K = 64 in f64 ----
    sim64 = vi_smoother.simulate_vi(dtype=f64, device=dev,
                                    **{**VI_K, "n_keyframes": 64})
    z64 = torch.zeros(6, dtype=f64, device=dev)
    pre64 = vi_smoother.preintegrate_segments(sim64, z64[:3], z64[3:],
                                              sigma_g=2e-4, sigma_a=2e-3)
    chain, cf, launches, ms_c = run_phase(
        "path K64 chain", lambda costs: vi_chain.solve_vi_chain(
            pre64, sim64.obs_poses, sim64.obs_poses, sim64.vels_true, z64,
            max_iters=40, costs=costs, **VI_SIG))
    launches_of["K64_chain"] = launches
    dense_solve = lambda iters: vi_smoother.solve_vi_smoother(  # noqa: E731
        pre64, sim64.obs_poses, sim64.obs_poses, sim64.vels_true, z64,
        max_iters=iters, **VI_SIG)
    dense_solve(1)       # torch.func's first use, outside the timed run
    dense, cfd, launches_d, ms_d = run_phase(
        "path K64 dense", lambda costs: dense_solve(40),
        iters_of=lambda o: o.iterations)
    launches_of["K64_dense"] = launches_d
    cost_rel = abs(float(chain.cost) - float(dense.cost)) / float(dense.cost)
    pose_err = max(float((chain.poses.t - dense.poses.t).abs().max()),
                   float((chain.poses.R - dense.poses.R).abs().max()))
    _log("path K64", f"f64: chain {chain.it} iterations {ms_c:.3f} ms each, "
                     f"dense {dense.iterations} iterations {ms_d:.3f} ms each "
                     f"(spd_solve n = {9 * 64 + 6}: {launches_d['spd_solve']} "
                     f"launches); cost {float(chain.cost):.12e} against "
                     f"{float(dense.cost):.12e} (rel {cost_rel:.3e}, gate "
                     f"{K64_COST_RTOL}); poses {pose_err:.3e} (gate "
                     f"{K64_POSE_TOL})")
    if (launches["tridiag_solve"] != chain.it
            or launches_d["spd_solve"] != dense.iterations
            or launches_d["tridiag_solve"]):
        raise AssertionError(f"path K64 launches: chain {launches}, dense "
                             f"{launches_d}")
    if not (cost_rel <= K64_COST_RTOL and pose_err <= K64_POSE_TOL):
        raise AssertionError(f"path K64: chain and dense differ: cost "
                             f"{cost_rel}, poses {pose_err}")
    calls, _ = captured_calls([(common, "spd_solve")],
                              lambda: dense_solve(1))
    spd["path_K64_n582_float64"] = {**check_spd(*calls[0], "path K64 dense"),
                                    "launches": launches_d["spd_solve"]}
    phases["K64"] = {"chain_ms_per_lm_iter": ms_c, "chain_iters": chain.it,
                     "dense_ms_per_lm_iter": ms_d,
                     "dense_iters": dense.iterations,
                     "final_cost": float(dense.cost), "cost_rel": cost_rel,
                     "pose_err": pose_err, "launches_dense": launches_d}
    del sim64, pre64, chain, dense, calls

    # ---- N: solve_vi_ba, K = 12, 60 landmarks, a 0.7x-scaled start ----
    simn = vi_smoother.simulate_vi(n_keyframes=12, samples_per_seg=100,
                                   dt=0.005, sigma_g=1e-4, sigma_a=1e-3,
                                   seed=11, device=dev)
    pts, uv, w = vi_smoother.simulate_vi_landmarks(simn, n_landmarks=60,
                                                   uv_noise=5e-4, seed=2)
    s0, c0 = 0.7, simn.poses_true.t[0]
    poses0 = se3.SE3(simn.poses_true.R, c0 + s0 * (simn.poses_true.t - c0))
    zn = torch.zeros(6, dtype=f64, device=dev)
    pren = vi_smoother.preintegrate_segments(simn, zn[:3], zn[3:],
                                             sigma_g=1e-4, sigma_a=1e-3)
    prior = se3.SE3(simn.poses_true.R[0], simn.poses_true.t[0])
    ba_solve = lambda iters: vi_smoother.solve_vi_ba(  # noqa: E731
        pren, uv, w, poses0, s0 * simn.vels_true, zn, c0 + s0 * (pts - c0),
        pose0_prior=prior, max_iters=iters)
    (sol_n, _), cfn, launches_n, ms_n = run_phase(
        "path N", lambda costs: ba_solve(40),
        iters_of=lambda o: o[0].iterations)
    t_est, t_true = sol_n.poses.t, simn.poses_true.t
    scale = float(((t_est[1:] - t_est[:-1]).norm(dim=1)
                   / (t_true[1:] - t_true[:-1]).norm(dim=1)).mean())
    n_sys = 12 * 9 + 6 + 60 * 3
    _log("path N", f"{int(w.sum())} observations, n = {n_sys}: "
                   f"{sol_n.iterations} iterations, {ms_n:.3f} ms each, "
                   f"cost {float(sol_n.cost):.6e}; scale {scale:.6f} from "
                   f"{s0} (gate |scale - 1| < {N_SCALE_ERR})")
    if launches_n["spd_solve"] != sol_n.iterations:
        raise AssertionError(f"path N launches {launches_n}")
    if not abs(scale - 1.0) < N_SCALE_ERR:
        raise AssertionError(f"path N: scale {scale}")
    launches_of["N"] = launches_n
    calls, _ = captured_calls([(common, "spd_solve")], lambda: ba_solve(1))
    spd["path_N_n294_float64"] = {**check_spd(*calls[0], "path N"),
                                  "launches": launches_n["spd_solve"]}
    phases["N"] = {"ms_per_lm_iter": ms_n, "iters": sol_n.iterations,
                   "final_cost": float(sol_n.cost), "scale": scale,
                   "launches": launches_n}
    del simn, pren, sol_n, calls

    # ---- U: vi_initialize, filter_trajectory, mechanize_trajectory ----
    t0 = time.perf_counter()
    simu = vi_smoother.simulate_vi(n_keyframes=12, samples_per_seg=50,
                                   dt=0.005, bg=(0, 0, 0), ba=(0, 0, 0),
                                   device=dev)
    z3 = torch.zeros(3, dtype=f64, device=dev)
    init = vi_init.vi_initialize(
        vi_smoother.preintegrate_segments(simu, z3, z3),
        se3.SE3(simu.poses_true.R, simu.poses_true.t / 2.3))
    scale_err = abs(float(init.scale) - 2.3)

    rng = np.random.default_rng(13)
    n = 80
    truth = spiral_poses(n, device=dev)
    odo_sig, obs_sig = 0.002, 0.05
    noisy = lambda T, sig: se3.mul(T, se3.exp(torch.as_tensor(  # noqa: E731
        rng.normal(size=6) * sig, dtype=f64, device=dev)))
    Ti, Tj = se3.SE3(truth.R[:-1], truth.t[:-1]), se3.SE3(truth.R[1:],
                                                          truth.t[1:])
    odo_l, obs_l = [], []
    for k in range(n - 1):
        Tk = se3.SE3(Ti.R[k], Ti.t[k])
        Tk1 = se3.SE3(Tj.R[k], Tj.t[k])
        odo_l.append(noisy(se3.mul(se3.inv(Tk), Tk1), odo_sig))
        obs_l.append(noisy(Tk1, obs_sig))
    odo = se3.SE3(torch.stack([o.R for o in odo_l]),
                  torch.stack([o.t for o in odo_l]))
    obs = se3.SE3(torch.stack([o.R for o in obs_l]),
                  torch.stack([o.t for o in obs_l]))
    eye6 = torch.eye(6, dtype=f64, device=dev)
    Ts, fin = eskf.filter_trajectory(
        se3.SE3(truth.R[0], truth.t[0]), eye6 * 1e-6, odo, obs,
        torch.ones(n - 1, dtype=torch.bool, device=dev), eye6 * odo_sig ** 2,
        eye6 * obs_sig ** 2)
    ate_f = float(metrics.ate_rmse(Ts, Tj))
    ate_o = float(metrics.ate_rmse(obs, Tj))

    lat, dt_ins, n_ins = np.deg2rad(30.0), 0.01, 6000
    ell = ins.ELLIPSOIDS["WGS84"]
    lat_t = torch.tensor(lat, dtype=f64, device=dev)
    g = float(ins.normal_gravity(lat_t, torch.zeros_like(lat_t)))
    om = ell["omega"]
    w_ie = torch.tensor([om * np.cos(lat), 0.0, -om * np.sin(lat)],
                        dtype=f64, device=dev)
    state0 = ins.INSState(lat=lat_t, lon=torch.zeros_like(lat_t),
                          h=torch.zeros_like(lat_t),
                          v_ned=torch.zeros(3, dtype=f64, device=dev),
                          q_nb=torch.tensor([1.0, 0, 0, 0], dtype=f64,
                                            device=dev))
    hist = ins.mechanize_trajectory(
        state0, (w_ie * dt_ins).expand(n_ins, 3),
        torch.tensor([0.0, 0.0, -g * dt_ins], dtype=f64,
                     device=dev).expand(n_ins, 3), dt_ins)
    torch.cuda.synchronize()
    u_s = time.perf_counter() - t0
    drift = abs(float(hist.lat[-1]) - lat) * 6.37e6
    dh = abs(float(hist.h[-1]))
    speed = float(torch.linalg.vector_norm(hist.v_ned[-1]))
    finite = all(bool(torch.isfinite(f).all()) for f in hist)
    _log("path U", f"f64, {u_s:.2f} s (host clock): vi_initialize scale "
                   f"{float(init.scale):.8f} (|s - 2.3| {scale_err:.2e}, gate "
                   f"{U_SCALE_ERR}), |g| {float(init.gravity.norm()):.6f}; "
                   f"ESKF {n} steps ATE {ate_f:.4e} against the observations'"
                   f" {ate_o:.4e} (gate < {U_ESKF_ATE_RATIO} x); INS {n_ins} "
                   f"steps: drift {drift:.3e} m, height {dh:.3e} m, speed "
                   f"{speed:.3e} m/s (gates {U_INS_DRIFT_M} m, "
                   f"{U_INS_SPEED} m/s), finite {finite}")
    if not (scale_err < U_SCALE_ERR and ate_f < U_ESKF_ATE_RATIO * ate_o
            and finite and drift < U_INS_DRIFT_M and dh < U_INS_DRIFT_M
            and speed < U_INS_SPEED):
        raise AssertionError("path U: a gate failed")
    phases["U"] = {"seconds": u_s, "scale": float(init.scale),
                   "eskf_ate": ate_f, "eskf_ate_obs": ate_o,
                   "ins_drift_m": drift, "ins_speed": speed}
    wall = time.perf_counter() - t_start
    _log("inertial", f"paths J, K, K64, N and U with their kernel checks: "
                     f"{wall:.1f} s of wall time")
    phases["inertial"] = {"wall_s": wall}
    return {"tridiag": tri, "spd": spd, "launches": launches_of}


# ---- slice E: geometric vision (paths Z, X, M, H, Y and RS) ----

GEO_Z = dict(n_views=9, noise=0.3, seed=7)      # bench.py:582-631, f32
GEO_Z_FX, GEO_Z_FY = 600.0, 590.0
Z_F_ERR = 1.0               # Z: |fx - 600| and |fy - 590| after the
#                             refinement (tests/test_posegraph_calib.py:51)
Z_RMS_MAX = 0.5             # Z: RMS reprojection error in px (noise 0.3)
Z8_DIST = (-0.25, 0.07, 0.0, 1e-4, -5e-5)   # tests/test_posegraph_calib.py:
Z8_RMS_MAX = 0.15           # 42-63: seed 8, noise 0.1, f64, 60 iterations;
Z8_CURVE_PX = 0.5           # the distortion curve within 0.5 px to r 0.38
Z9_RMS_MAX, Z9_FX_ERR = 1e-8, 1e-5   # :66-70: seed 9, noiseless, 6 views
GEO_X = dict(n_points=2000, noise=1e-3, seed=8)   # bench.py:655-696, f32
X_POSE_TOL = 2e-3           # R and t / |t| (tests/test_initialization.py:69,
X_GATE_NOISE = 1e-4         # whose scene has noise 1e-4: at the bench's 1e-3
#                             the optimum's t is 2.37e-3 off the truth, the
#                             JAX package's f64 solve too; there the f32
X_VS_F64_TOL = 1e-4         # solve is held to the f64 one of the scene
GEO_M = dict(batch=8192, n_obs=32, iters=10, seed=4)   # bench.py:425-453
M_COST_MAX = 1e-12          # M: the batch's largest cost, f32, noiseless data
GEO_H = dict(n=8192, sweeps=10, seed=6)          # bench.py:477-505, f32
H_POSE_TOL = 1e-4
GEO_Y_PX = 65_536           # bench.py:391-401 at its smoke size, f32
RS_PARAB_TOL = 1e-6         # tests/test_initialization.py:109-126
RS_SIGMA2 = 4e-8            # tests/test_robust_epipolar.py:15-38
RS_CLEAN_KEPT = 0.9
RS_SAMPSON_RMS = 5e-4


def geometry_paths(dev, run_phase, check_spd, check_assemble, phases):
    """Paths Z (Zhang calibration), X (the two-view pipeline), M (batched
    PnP), H (SE(3) ICP), Y (generic Newton undistortion) and RS (RANSAC and
    robust_fundamental), each run with every launch count set to 0 just
    before it (run_phase) and gated. spd_solve is held against plain
    (check_spd) at n = 63 (Z: f32 on the bench's scene, f64 on the JAX
    test's distorted one) and n = 12 (X, f32 and f64), ba_assemble
    (check_assemble) at X's (K 2, L 2000) grid. Returns {"spd": {label:
    numbers}, "assemble": {label: numbers}, "launches": {path: counts}}."""
    import numpy as np
    import torch

    from slam_tricks_tpu_torch.initialization import robust_epipolar
    from slam_tricks_tpu_torch.initialization.ransac import ransac
    from slam_tricks_tpu_torch.initialization.zhang import \
        calibrate_closed_form
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.ops import ba_assemble
    from slam_tricks_tpu_torch.pipelines import calibration, two_view
    from slam_tricks_tpu_torch.residuals import (camera, epipolar, icp,
                                                 simple)
    from slam_tricks_tpu_torch.sim import make_calib_scene, make_two_view
    from slam_tricks_tpu_torch.solvers import common, schur_flat_sm
    from slam_tricks_tpu_torch.solvers.pnp import solve_pnp_batched

    f32, f64 = torch.float32, torch.float64
    t_start = time.perf_counter()
    spd, asm, launches_of = {}, {}, {}

    # ---- Z: Zhang calibration, the bench's f32 scene on the card ----
    cs = make_calib_scene(dtype=f32, device=dev, **GEO_Z)
    intr0, _, poses0 = calibrate_closed_form(cs.board_pts, cs.image_pts)
    init_ms = _time_ms(lambda: calibrate_closed_form(cs.board_pts,
                                                     cs.image_pts),
                       rounds=3, reps=3)
    fx0_err = abs(float(intr0.fx) - GEO_Z_FX)
    costs_z = []
    real_lm = calibration.levenberg_marquardt

    def lm_recording(*a, **kw):     # the per-step costs of calibrate's LM
        return real_lm(*a, callback=lambda it, c, lam: costs_z.append(c),
                       **kw)

    def refine(iters=30):
        costs_z.clear()
        calibration.levenberg_marquardt = lm_recording
        try:
            return calibration.calibrate(cs.board_pts, cs.image_pts,
                                         max_iters=iters,
                                         init=(intr0, poses0))
        finally:
            calibration.levenberg_marquardt = real_lm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refine()                        # the first call, timed alone
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    res, _, launches, ms = run_phase("path Z", lambda costs: refine(),
                                     iters_of=lambda o: o.iterations)
    cz = [float(c) for c in costs_z]
    refine_ms = ms * res.iterations
    fx_err = abs(float(res.intrinsics.fx) - GEO_Z_FX)
    fy_err = abs(float(res.intrinsics.fy) - GEO_Z_FY)
    rms = float(res.rms_px)
    _log("path Z", f"{GEO_Z['n_views']} views f32 (n = "
                   f"{9 + 6 * GEO_Z['n_views']}): closed-form start "
                   f"{init_ms:.3f} ms on the card (CUDA events), its "
                   f"|fx - 600| {fx0_err:.4f}; refinement {res.iterations} LM"
                   f" iterations, {refine_ms:.3f} ms ({ms:.4f} ms an "
                   f"iteration; its first call {first_s:.3f} s, host clock,"
                   f" after path K64's first use of torch.func), cost "
                   f"{cz[0]:.6e} -> {cz[-1]:.6e} after the first step; "
                   f"|fx - 600| {fx_err:.4f}, |fy - 590| "
                   f"{fy_err:.4f} (gate < {Z_F_ERR}), RMS {rms:.4f} px (gate "
                   f"< {Z_RMS_MAX}); launches {launches}")
    _check_costs(cz, math.inf, "path Z")
    if launches["spd_solve"] != res.iterations:
        raise AssertionError(f"path Z: launches {launches} in "
                             f"{res.iterations} iterations")
    if not (fx_err < Z_F_ERR and fy_err < Z_F_ERR and rms < Z_RMS_MAX):
        raise AssertionError(f"path Z: fx {fx_err}, fy {fy_err}, RMS {rms}")
    launches_of["Z"] = launches
    calls, _ = captured_calls([(common, "spd_solve")], lambda: refine(1))
    spd["path_Z_n63_float32"] = {**check_spd(*calls[0], "path Z"),
                                 "launches": launches["spd_solve"]}
    phases["Z"] = {"init_ms": init_ms, "init_fx_err": fx0_err,
                   "refine_ms": refine_ms, "ms_per_lm_iter": ms,
                   "first_call_s": first_s, "iters": res.iterations,
                   "final_cost": cz[-1], "fx_err": fx_err, "fy_err": fy_err,
                   "rms_px": rms, "launches": launches}

    # the JAX tests' f64 scenes on the card, with their gates
    dist8 = camera.DistCoeffs(*Z8_DIST)
    cs8 = make_calib_scene(n_views=9, noise=0.1, dist=dist8, seed=8,
                           device=dev)
    res8 = calibration.calibrate(cs8.board_pts, cs8.image_pts, max_iters=60)
    r = torch.linspace(0.0, 0.38, 50, dtype=f64, device=dev)
    curve = torch.stack([r, 0.6 * r], dim=1)
    curve_px = float((camera.distort_normalized(dist8, curve)
                      - camera.distort_normalized(res8.distortion, curve))
                     .abs().max()) * cs8.fx
    f8 = (abs(float(res8.intrinsics.fx) - cs8.fx),
          abs(float(res8.intrinsics.fy) - cs8.fy))
    cs9 = make_calib_scene(n_views=6, noise=0.0, seed=9, device=dev)
    res9 = calibration.calibrate(cs9.board_pts, cs9.image_pts, max_iters=40)
    fx9 = abs(float(res9.intrinsics.fx) - cs9.fx)
    _log("path Z f64", f"seed 8 (distorted, noise 0.1): {res8.iterations} "
                       f"iterations, RMS {float(res8.rms_px):.6f} px (gate < "
                       f"{Z8_RMS_MAX}), |fx - 600| {f8[0]:.4f}, |fy - 590| "
                       f"{f8[1]:.4f} (< {Z_F_ERR}), distortion curve "
                       f"{curve_px:.4f} px (< {Z8_CURVE_PX}); seed 9 "
                       f"(noiseless, 6 views): {res9.iterations} iterations, "
                       f"RMS {float(res9.rms_px):.3e} (< {Z9_RMS_MAX}), "
                       f"|fx - 600| {fx9:.3e} (< {Z9_FX_ERR})")
    if not (float(res8.rms_px) < Z8_RMS_MAX and max(f8) < Z_F_ERR
            and curve_px < Z8_CURVE_PX and float(res9.rms_px) < Z9_RMS_MAX
            and fx9 < Z9_FX_ERR):
        raise AssertionError("path Z f64: a gate of the JAX tests failed")
    calls, _ = captured_calls([(common, "spd_solve")],
                              lambda: calibration.calibrate(
                                  cs8.board_pts, cs8.image_pts, max_iters=1))
    spd["path_Z_n63_float64"] = check_spd(*calls[0], "path Z f64")
    phases["Z"].update(f64_seed8_rms=float(res8.rms_px),
                       f64_seed8_curve_px=curve_px,
                       f64_seed9_rms=float(res9.rms_px))
    del cs, cs8, cs9, res, res8, res9, calls

    # ---- X: the two-view pipeline, 2000 points, f32 ----
    tv = make_two_view(dtype=f32, device=dev, **GEO_X)
    solve_x = lambda ri: two_view.solve_two_view(  # noqa: E731
        tv.uv1, tv.uv2, refine_iters=ri)
    solve_x(15)
    out_x, _, launches, ms_x = run_phase(
        "path X", lambda costs: solve_x(15), iters_of=lambda o: 1)
    out0, _, launches0, ms_x0 = run_phase(
        "path X init only", lambda costs: solve_x(0), iters_of=lambda o: 1)
    t_ref = tv.T_12.t / tv.T_12.t.norm()
    r_err = float((out_x.T_12.R - tv.T_12.R).abs().max())
    t_err = float((out_x.T_12.t - t_ref).abs().max())
    c15, c0 = float(out_x.final_cost), float(out0.final_cost)
    n_ch = float(out_x.n_cheiral)
    it_x = launches["spd_solve"]
    # the 2e-3 gate's own noise (1e-4) on the same 2000-point scene, f32;
    # at the bench's 1e-3 the optimum's t is ~2.4e-3 off the truth in both
    # packages, so there t is held to the f64 solve of the same scene
    tv_q = make_two_view(dtype=f32, device=dev, **{**GEO_X,
                                                   "noise": X_GATE_NOISE})
    out_q = two_view.solve_two_view(tv_q.uv1, tv_q.uv2, refine_iters=15)
    tq_ref = tv_q.T_12.t / tv_q.T_12.t.norm()
    q_err = max(float((out_q.T_12.R - tv_q.T_12.R).abs().max()),
                float((out_q.T_12.t - tq_ref).abs().max()))
    tv64 = make_two_view(dtype=f64, device=dev, **GEO_X)
    out64 = two_view.solve_two_view(tv64.uv1, tv64.uv2, refine_iters=15)
    vs64 = max(float((out_x.T_12.R.double() - out64.T_12.R).abs().max()),
               float((out_x.T_12.t.double() - out64.T_12.t).abs().max()))
    _log("path X", f"{GEO_X['n_points']} points f32: {ms_x:.3f} ms with the "
                   f"refinement (15 iterations at most; {it_x} taken), "
                   f"{ms_x0:.3f} ms init only (CUDA events); cost {c0:.6e} "
                   f"-> {c15:.6e}; n_cheiral {n_ch:.0f}; |R - R_true| "
                   f"{r_err:.3e} (gate {X_POSE_TOL}), |t - t_true| "
                   f"{t_err:.3e} (the optimum's at noise 1e-3; against the "
                   f"f64 solve {vs64:.3e}, gate {X_VS_F64_TOL}); at noise "
                   f"{X_GATE_NOISE} R and t {q_err:.3e} off the truth (gate "
                   f"{X_POSE_TOL}); launches {launches} (init only "
                   f"{launches0})")
    if not (n_ch == GEO_X["n_points"] and c15 <= c0 and r_err < X_POSE_TOL
            and q_err < X_POSE_TOL and vs64 < X_VS_F64_TOL
            and math.isfinite(c15)):
        raise AssertionError(f"path X: n_cheiral {n_ch}, cost {c0} -> {c15},"
                             f" R {r_err}, at noise {X_GATE_NOISE} {q_err}, "
                             f"against f64 {vs64}")
    if not (it_x >= 1 and launches["ba_assemble"] == it_x + 1
            and launches0["ba_assemble"] == 1
            and launches0["spd_solve"] == 0):
        raise AssertionError(f"path X: launches {launches}, {launches0}")
    launches_of["X"] = launches
    asm_calls, spd_calls, _ = captured_calls(
        [(schur_flat_sm, "linearize_assemble"), (schur_flat_sm, "spd_solve")],
        lambda: solve_x(1))
    a_x = asm_calls[0]
    # at the refinement's start every landmark sits at its two rays'
    # midpoint, so its gradient gl is a cancelling sum, as at an optimum:
    # the kernel is held to plain at X's grid with the points 1% further
    # from camera 0, and at the start itself kernel and plain are each
    # held to the plain version in f64 of the same inputs
    moved = (*a_x[:2], a_x[2] * 1.01, *a_x[3:7])
    asm["path_X"] = {**dict(zip(
        ("err", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by"),
        check_assemble(moved, a_x[7], "path X grid", a_x[8]))),
        "grid": list(a_x[5].shape), "launches": launches["ba_assemble"]}
    check_assemble(a_x[:7], a_x[7], "path X start", a_x[8], timed=False,
                   ref64=True)
    spd["path_X_n12_float32"] = {**check_spd(*spd_calls[0], "path X"),
                                 "launches": it_x}
    calls, _ = captured_calls([(schur_flat_sm, "spd_solve")],
                              lambda: two_view.solve_two_view(
                                  tv64.uv1, tv64.uv2, refine_iters=1))
    spd["path_X_n12_float64"] = check_spd(*calls[0], "path X f64")
    phases["X"] = {"ms": ms_x, "ms_init_only": ms_x0, "iters": it_x,
                   "final_cost": c15, "init_only_cost": c0,
                   "n_cheiral": n_ch, "R_err": r_err, "t_err": t_err,
                   "vs_f64": vs64, "gate_noise_err": q_err,
                   "launches": launches}
    del tv, tv64, tv_q, out_x, out0, out64, out_q, asm_calls, spd_calls, a_x
    del calls

    # ---- M: batched PnP, 8192 problems x 32 points, f32 ----
    B, M_, iters_m = GEO_M["batch"], GEO_M["n_obs"], GEO_M["iters"]
    rng = np.random.default_rng(GEO_M["seed"])

    def T_(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    pts = T_(rng.uniform([-2, -2, 4], [2, 2, 8], (B, M_, 3)))
    T_true = se3.exp(T_(rng.normal(size=(B, 6)) * 0.2))
    p_cam = se3.act(se3.SE3(T_true.R[:, None], T_true.t[:, None]), pts)
    uv = p_cam[..., :2] / p_cam[..., 2:]
    T0 = se3.retract(T_true, T_(rng.normal(size=(B, 6)) * 0.05))
    def solve_m():
        return solve_pnp_batched(T0, pts, uv, iters=iters_m)

    solve_m()
    out_m, _, launches, ms_m = run_phase("path M", lambda costs: solve_m(),
                                         iters_of=lambda o: 1)
    ms_m = min(ms_m, _time_ms(solve_m, rounds=3, reps=2))
    cmax = float(out_m.cost.max())
    _log("path M", f"{B} problems x {M_} points, {iters_m} GN iterations, "
                   f"f32: {ms_m:.3f} ms a batch (CUDA events), "
                   f"{B / ms_m * 1e3:.4e} problems/s, "
                   f"{B * iters_m / ms_m * 1e3:.4e} GN iterations/s; max "
                   f"cost {cmax:.3e} (gate < {M_COST_MAX}), iterations "
                   f"{int(out_m.iterations.min())}-"
                   f"{int(out_m.iterations.max())}; launches {launches}")
    if not cmax < M_COST_MAX:
        raise AssertionError(f"path M: max cost {cmax}")
    phases["M"] = {"ms": ms_m, "problems_per_s": B / ms_m * 1e3,
                   "gn_iters_per_s": B * iters_m / ms_m * 1e3,
                   "max_cost": cmax, "iters": iters_m}
    del pts, T_true, p_cam, uv, T0, out_m

    # ---- H: SE(3) ICP, 8192 points, unknown correspondences, f32 ----
    rng = np.random.default_rng(GEO_H["seed"])
    src = T_(rng.normal(size=(GEO_H["n"], 3)))
    T_h = se3.exp(torch.tensor([0.08, -0.05, 0.1, 0.15, -0.1, 0.05],
                               dtype=f32, device=dev))
    dst = se3.act(T_h, src)
    def run_h():
        return icp.icp_iterate(src, dst, n_outer=GEO_H["sweeps"])

    run_h()
    (R_h, t_h, _, idx_h), _, launches, ms_h = run_phase(
        "path H", lambda costs: run_h(), iters_of=lambda o: 1)
    rh_err = float((R_h - T_h.R).abs().max())
    th_err = float((t_h - T_h.t).abs().max())
    exact = float((idx_h == torch.arange(GEO_H["n"], device=dev)).double()
                  .mean())
    _log("path H", f"{GEO_H['n']} points f32, {GEO_H['sweeps']} sweeps: "
                   f"{ms_h:.3f} ms (CUDA events); |R - R_true| {rh_err:.3e}, "
                   f"|t - t_true| {th_err:.3e} (gate {H_POSE_TOL}); "
                   f"association exact for {exact:.4f} of the points; "
                   f"launches {launches}")
    if not (rh_err < H_POSE_TOL and th_err < H_POSE_TOL):
        raise AssertionError(f"path H: R {rh_err}, t {th_err}")
    phases["H"] = {"ms": ms_h, "R_err": rh_err, "t_err": th_err,
                   "sweeps": GEO_H["sweeps"], "exact_assoc": exact}
    del src, dst, idx_h

    # ---- Y: generic Newton undistortion against the undistort kernel ----
    intr = camera.Intrinsics(458.654, 457.296, 367.215, 248.375)
    dist = camera.DistCoeffs(-0.28340811, 0.07395907, 0.0, 0.00019359,
                             1.76187114e-05)
    px = torch.as_tensor(np.random.default_rng(3).uniform(
        [50, 50], [700, 430], (GEO_Y_PX, 2)), dtype=f32, device=dev)
    dpx = camera.distort_pixels(intr, dist, px).contiguous()
    fast = camera.undistort_points_fast(intr, dist, dpx)     # the kernel
    und, _, launches, ms_y = run_phase(
        "path Y", lambda costs: camera.undistort_points_gn(intr, dist, dpx),
        iters_of=lambda o: 1)
    y_err = float((und - fast).abs().max())
    ms_y = min(ms_y, _time_ms(lambda: camera.undistort_points_gn(
        intr, dist, dpx), rounds=3, reps=3))
    _log("path Y", f"{GEO_Y_PX} px f32, 5 exact Newton steps in plain torch:"
                   f" {ms_y:.4f} ms ({GEO_Y_PX / ms_y * 1e3:.4e} px/s); max "
                   f"|gn - kernel| {y_err:.3e} px (gate {UNDISTORT_TOL}), "
                   f"round trip {float((und - px).abs().max()):.3e} px; "
                   f"launches {launches}")
    if not (und.shape == px.shape and y_err <= UNDISTORT_TOL):
        raise AssertionError(f"path Y: {y_err} px against the kernel")
    phases["Y"] = {"ms": ms_y, "px_per_s": GEO_Y_PX / ms_y * 1e3,
                   "max_err_vs_kernel_px": y_err}
    del px, dpx, fast, und

    # ---- RS: RANSAC and robust_fundamental, f64, generators on the card --
    rng = np.random.default_rng(7)
    xs = rng.uniform(-3, 3, 300)
    clean = xs ** 2 + 2 * xs + 3
    outlier = rng.random(300) < 0.5
    ys = np.where(outlier, clean + rng.uniform(-30, 30, 300), clean)
    data = {"x": torch.as_tensor(xs, device=dev),
            "y": torch.as_tensor(ys, device=dev)}
    run_rs = lambda: ransac(  # noqa: E731
        torch.Generator(device=dev).manual_seed(0), data,
        min_fit=lambda d: simple.parabola_fit_lsq(d["x"], d["y"]),
        residual_sq=lambda p, d: simple.parabola_residual(
            p, d["x"], d["y"]) ** 2,
        refit=lambda d, w: simple.parabola_fit_lsq(d["x"], d["y"], w),
        subset_size=3, n_hyps=256, inlier_thresh_sq=0.01)
    run_rs()
    res_p, _, launches, ms_p = run_phase("path RS parabola",
                                         lambda costs: run_rs(),
                                         iters_of=lambda o: 1)
    p_err = float((res_p.params - torch.tensor([1.0, 2.0, 3.0], dtype=f64,
                                               device=dev)).abs().max())
    s6 = make_two_view(n_points=80, noise=1e-4, seed=6, device=dev)
    rng = np.random.default_rng(37)
    uv1, uv2 = s6.uv1, s6.uv2.clone()
    bad = rng.choice(80, 20, replace=False)
    uv2[bad] += torch.as_tensor(rng.uniform(0.05, 0.3, size=(20, 2))
                                * rng.choice([-1, 1], (20, 2)), device=dev)
    run_rf = lambda: robust_epipolar.robust_fundamental(  # noqa: E731
        uv1, uv2, sigma2=RS_SIGMA2, essential=True,
        generator=torch.Generator(device=dev).manual_seed(0))
    run_rf()
    (E, inl, _), _, launches_f, ms_f = run_phase(
        "path RS robust_fundamental", lambda costs: run_rf(),
        iters_of=lambda o: 1)
    inl = inl.cpu().numpy()
    keep = np.setdiff1d(np.arange(80), bad)
    kept = float(inl[keep].mean())
    samp = float(torch.sqrt(epipolar.sampson(E, uv1[keep], uv2[keep])
                            .mean()))
    _log("path RS", f"f64: RANSAC parabola (300 samples, 50% outliers, 256 "
                    f"hypotheses) {ms_p:.3f} ms, |params - (1, 2, 3)| "
                    f"{p_err:.3e} (gate {RS_PARAB_TOL}), {int(res_p.n_inliers)}"
                    f" inliers; robust_fundamental (80 matches, 20 corrupted)"
                    f" {ms_f:.3f} ms: corrupted kept {int(inl[bad].sum())} "
                    f"(gate 0), clean kept {kept:.4f} (gate > "
                    f"{RS_CLEAN_KEPT}), Sampson RMS {samp:.3e} (gate < "
                    f"{RS_SAMPSON_RMS}); launches {launches}, {launches_f}")
    if not (p_err < RS_PARAB_TOL and not inl[bad].any()
            and kept > RS_CLEAN_KEPT and samp < RS_SAMPSON_RMS):
        raise AssertionError("path RS: a gate failed")
    phases["RS"] = {"ms_ransac": ms_p, "ms_robust_fundamental": ms_f,
                    "params_err": p_err, "clean_kept": kept,
                    "sampson_rms": samp}
    wall = time.perf_counter() - t_start
    _log("geometry", f"paths Z, X, M, H, Y and RS with their kernel checks: "
                     f"{wall:.1f} s of wall time")
    phases["geometry"] = {"wall_s": wall}
    return {"spd": spd, "assemble": asm, "launches": launches_of}


FE_SHAPE = (480, 640)       # VGA frames, float32: a VO or calibration front
FE_SEED = 21                # end's input (st5, st10, st11, st13 run on such)
FO_SIGMA, FO_K, FO_R = 1.5, 1000, 4
FO_REL_TOL = 1e-5           # FO: card f32 against CPU f64, max |d| / max |ref|
FO_UNDIST_TOL = 1e-3        # FO: undistort_image, |d| in intensity (0..1)
SD_POINTS, SD_BEAMS = 4096, 1440
SD_ROW_TIME = 1.0 / (30 * 480)   # 480 rows read out over a 30 Hz frame
SD_REL_TOL = 1e-5           # SD: card f32 against CPU f64, relative
LK_ARGS = dict(levels=3, win=7, iters=15)
LK_SEEDS = dict(grid=16, pts_per_cell=4, margin=20, seed=2)   # 1024 points
LK_SHIFT = (3.4, -2.2)      # tests/test_optical_flow_panorama.py:42-53
LK_MEDIAN_ERR = 0.25        # px, each axis (the JAX test's gate)
LK_CPU_TOL = 1e-2           # px, card f32 against CPU f64 where both valid
LK_VALID_AGREE = 0.99       # and the share of points valid on both or neither
DA_TWIST = [0.05, -0.03, 0.02, 0.004, -0.006, 0.003]   # tests/test_distortion
DA_DEPTH = 5.0              # _direct.py:76-114: the motion and the depth;
DA_F = 600.0                # its f = 150 and texture sigma 3 at 160 x 120,
DA_SIGMA = 12.0             # scaled with the frame to 640 x 480
DA_ARGS = dict(k=2048, max_iters=40)
DA_LOG_ERR = 1e-2           # max |log(T_est^-1 T_true)| (the JAX test's)
DA_CPU_TOL = 2e-3           # and card f32 against CPU f64, the same measure
ORB_SHAPES = 200            # polygons (tests/test_orb.py's 50 at 320 x 240)
ORB_N, ORB_DEG = 1000, 30.0
ORB_MATCH = dict(ratio=0.8, max_hamming=48)
ORB_MIN_MATCHES, ORB_MIN_FRAC = 30, 0.7   # tests/test_orb.py:50-66
ORB_KEEP = 0.95             # card f32 against CPU f64: keypoints in common
ORB_BITS = 0.01             # and descriptor bits that differ among them
CB_BOARD = dict(rows=7, cols=9, square_px=40, angle=0.15, noise=0.01,
                seed=11)    # 7 x 9 interior corners, 8 x 10 squares of 40 px
CB_PX = 1.0                 # every true corner detected within 1 px
CB_CPU_TOL = 1e-2           # px, card f32 against CPU f64 corners
PAN_CROPS = ((0, 0), (64, 6), (128, 12))   # (x, y) of three 640 x 480 crops
PAN_PX = 0.5                # each pairwise H's shift (the JAX test's gates,
PAN_MIN_INLIERS = 15        # tests/test_optical_flow_panorama.py:68-80)
PAN_CPU_PX = 1e-6           # card f64 against CPU f64 on the same 256
                            # subsets: the good fits (> 15 inliers) at the
                            # frame corners (the counts equal). RANSAC's
                            # refit takes near-inliers, so H itself moves
                            # ~0.1 px with the draws: f32 is held to the gate
PAN_CANVAS_TOL = 1e-2       # mean |canvas - base image| where covered (a
                            # stitch a pixel off leaves ~0.1)


def _canvas_err(canvas, covered, base):
    """mean |canvas - base| over the covered pixels, the canvas laid on the
    base image at the best of the offsets -1, 0 and 1 in each axis: a
    canvas's origin is the floor of its corners, which an estimated
    homography may put one pixel off the exact shift's."""
    import numpy as np

    ii, jj = np.nonzero(covered)
    best = float("inf")
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            bi, bj = ii + oy, jj + ox
            if (bi.min() < 0 or bj.min() < 0 or bi.max() >= base.shape[0]
                    or bj.max() >= base.shape[1]):
                continue
            best = min(best, float(np.abs(canvas[ii, jj] - base[bi, bj])
                                   .mean()))
    return best


def frontend_paths(dev, run_phase, phases):
    """Paths FO (image ops), SD (distortion simulators), LK (optical flow),
    DA (direct alignment), ORB, CB (chessboard detection) and PAN (panorama
    stitching, Harris and ORB features) at VGA, float32 on the card, each
    run with every launch count set to 0 just before it (run_phase), timed
    by CUDA events, held to the same port function on the CPU in float64
    and gated as the JAX tests gate them. No path reaches a kernel: each
    must record 0 launches. Returns {"launches": {path: counts}}."""
    import numpy as np
    import torch

    from slam_tricks_tpu_torch.frontend import (chessboard, direct,
                                                optical_flow, orb)
    from slam_tricks_tpu_torch.initialization.ransac import (
        draw_subsets, hypothesis_scores)
    from slam_tricks_tpu_torch.manifolds import se2, se3
    from slam_tricks_tpu_torch.ops import image, nms
    from slam_tricks_tpu_torch.pipelines import panorama
    from slam_tricks_tpu_torch.residuals import camera
    from slam_tricks_tpu_torch.sim import distortion, images

    f32, f64 = torch.float32, torch.float64
    cpu = torch.device("cpu")
    H, W = FE_SHAPE
    t_start = time.perf_counter()
    launches_of = {}

    def on(a, device=dev, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def phase(label, fn, n_items, unit):
        """run_phase on fn (every count 0 before it, which must stay 0),
        then the steady time a call: (out, ms, items/s)."""
        out, _, launches, ms_first = run_phase(label, lambda costs: fn(),
                                               iters_of=lambda o: 1)
        if any(launches.values()):
            raise AssertionError(f"{label} launched a kernel: {launches}")
        launches_of[label.split()[1]] = launches
        ms = _time_ms(fn, rounds=3, reps=3)
        rate = n_items / ms * 1e3
        _log(label, f"{ms:.3f} ms a call (CUDA events; first call "
                    f"{ms_first:.3f} ms), {rate:.4e} {unit}/s; launches "
                    f"{launches}")
        return out, ms, rate

    def rel(a, b):              # the card's a against the CPU's b
        return _rel(a.to(cpu, f64), b)

    # ---- FO: blur, Sobel, top-k peaks, undistort_image ----
    img_np = images.textured_image(H, W, seed=FE_SEED)
    img = on(img_np)
    intr = camera.Intrinsics(458.654, 457.296, 367.215, 248.375)   # path E's
    dist = camera.DistCoeffs(-0.28340811, 0.07395907, 0.0, 0.00019359,
                             1.76187114e-05)

    def run_fo(x=img):
        blur = image.gaussian_blur(x, FO_SIGMA)
        gx, gy = image.sobel(blur)
        mag = gx * gx + gy * gy
        return (blur, gx, gy, mag, nms.top_k_peaks(mag, FO_K, FO_R),
                image.undistort_image(x, intr, dist))

    (blur, gx, gy, mag, peaks, und), ms, fps = phase("path FO", run_fo, 1,
                                                     "frames")
    ref = run_fo(on(img_np, cpu, f64))
    errs = [rel(a, b) for a, b in zip((blur, gx, gy, mag), ref[:4])]
    und_err = float((und.to(cpu, f64) - ref[5]).abs().max())
    # top-k on the card's own scores, promoted: the same comparisons, the
    # same set and order
    want = nms.top_k_peaks(mag.to(cpu, f64), FO_K, FO_R)
    same_peaks = all(torch.equal(a.cpu(), b) for a, b in
                     zip(peaks[1:], want[1:])) and torch.equal(
        peaks[0].to(cpu, f64), want[0])
    n_peaks = int(torch.isfinite(peaks[0]).sum())
    _log("path FO", f"{H}x{W} f32: blur (sigma {FO_SIGMA}), Sobel, top-"
                    f"{FO_K} peaks (r {FO_R}, {n_peaks} valid), "
                    f"undistort_image; vs CPU f64: blur/gx/gy/|g|^2 "
                    f"{max(errs):.3e} (tol {FO_REL_TOL}), undistort "
                    f"{und_err:.3e} (tol {FO_UNDIST_TOL}); peaks equal to "
                    f"the CPU's on the same scores: {same_peaks}")
    if not (max(errs) < FO_REL_TOL and und_err < FO_UNDIST_TOL and same_peaks
            and n_peaks == FO_K and und.shape == img.shape):
        raise AssertionError("path FO: card and CPU differ")
    phases["FO"] = {"ms": ms, "frames_per_s": fps, "rel_err": max(errs),
                    "undistort_err": und_err, "peaks": n_peaks}

    # ---- SD: rolling shutter and LiDAR sweep ----
    rng = np.random.default_rng(FE_SEED)
    pts0_np = rng.uniform([0, 0], [W, H], (SD_POINTS, 2))
    vel_np = rng.normal(size=(SD_POINTS, 2)) * 300.0
    base_np = (0.3, (0.5, -0.2), (2.0, -1.0, 3.0))

    def run_sd(device=dev, dtype=f32):
        base = se2.SE2(torch.tensor(base_np[0], dtype=dtype, device=device),
                       torch.tensor(base_np[1], dtype=dtype, device=device))
        return (distortion.rolling_shutter_points(
                    on(pts0_np, device, dtype), on(vel_np, device, dtype),
                    SD_ROW_TIME),
                distortion.lidar_sweep(
                    distortion.box_segments(4.0, dtype, device), base,
                    torch.tensor(base_np[2], dtype=dtype, device=device),
                    n_beams=SD_BEAMS))

    (rs, sweep), ms, _ = phase("path SD", run_sd, SD_POINTS + SD_BEAMS,
                               "points and beams")
    rs_ref, sweep_ref = run_sd(cpu, f64)
    sd_err = max(rel(rs, rs_ref), *(rel(a, b) for a, b in
                                    zip(sweep, sweep_ref)))
    still = distortion.lidar_sweep(
        distortion.box_segments(4.0, f64, dev),
        se2.SE2(torch.tensor(0.0, dtype=f64, device=dev),
                torch.zeros(2, dtype=f64, device=dev)),
        torch.zeros(3, dtype=f64, device=dev), n_beams=SD_BEAMS)
    r = still.ranges.cpu().numpy()
    wall = np.max(np.abs(still.points_world.cpu().numpy()), axis=1)
    profile = (np.isfinite(r).all() and abs(r[0] - 4.0) < 1e-6
               and abs(r[SD_BEAMS // 8] - 4.0 * np.sqrt(2)) < 2e-1
               and np.all(np.abs(wall - 4.0) < 1e-6))
    _log("path SD", f"{SD_POINTS} rolling-shutter points ({H} rows), "
                    f"{SD_BEAMS}-beam sweep of a moving, turning base in "
                    f"box_segments: vs CPU f64 {sd_err:.3e} (tol "
                    f"{SD_REL_TOL}); static sweep profile (f64 on the card,"
                    f" the JAX test's gates): {profile}")
    if not (sd_err < SD_REL_TOL and profile):
        raise AssertionError(f"path SD: {sd_err}, profile {profile}")
    phases["SD"] = {"ms": ms, "items_per_s": (SD_POINTS + SD_BEAMS) / ms
                    * 1e3, "rel_err": sd_err}

    # ---- LK: pyramidal LK, 1024 seeds, a (3.4, -2.2) px shift ----
    lk2_np = images.shift_image(img_np, *LK_SHIFT)
    seeds_np = optical_flow.grid_seed_points(H, W, **LK_SEEDS)
    lk1, lk2, seeds = on(img_np), on(lk2_np), on(seeds_np)
    (pts2, valid), ms, pps = phase(
        "path LK", lambda: optical_flow.lk_track(lk1, lk2, seeds, **LK_ARGS),
        len(seeds_np), "points")
    pts2_ref, valid_ref = optical_flow.lk_track(
        on(img_np, cpu, f64), on(lk2_np, cpu, f64), on(seeds_np, cpu, f64),
        **LK_ARGS)
    v, vr = valid.cpu(), valid_ref
    both = v & vr
    agree = float((v == vr).double().mean())
    lk_cpu = float((pts2.to(cpu, f64) - pts2_ref)[both].abs().max())
    flow = (pts2 - seeds).cpu().numpy()[v.numpy()]
    med = np.median(np.abs(flow - LK_SHIFT), axis=0)
    _log("path LK", f"{len(seeds_np)} points, {LK_ARGS}: {int(v.sum())} "
                    f"valid, median error {med[0]:.4f}, {med[1]:.4f} px "
                    f"(gate {LK_MEDIAN_ERR}); vs CPU f64 {lk_cpu:.3e} px "
                    f"(tol {LK_CPU_TOL}), valid agree {agree:.4f}")
    if not (len(flow) > 10 and (med < LK_MEDIAN_ERR).all()
            and lk_cpu < LK_CPU_TOL and agree >= LK_VALID_AGREE):
        raise AssertionError(f"path LK: median {med}, vs CPU {lk_cpu}, "
                             f"agree {agree}")
    phases["LK"] = {"ms": ms, "points_per_s": pps, "median_err_px":
                    med.tolist(), "vs_cpu_px": lk_cpu, "valid": int(v.sum())}

    # ---- DA: direct alignment, k 2048, 40 LM iterations ----
    from scipy.ndimage import gaussian_filter

    tex = gaussian_filter(np.random.default_rng(3).normal(size=(H, W)),
                          DA_SIGMA)
    da1_np = (tex - tex.min()) / np.ptp(tex)
    intr_da = camera.Intrinsics(DA_F, DA_F, W / 2, H / 2)
    T_21 = se3.exp(torch.tensor(DA_TWIST, dtype=f64))
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    p2 = torch.as_tensor(np.stack([(xs - W / 2) / DA_F * DA_DEPTH,
                                   (ys - H / 2) / DA_F * DA_DEPTH,
                                   np.full_like(xs, DA_DEPTH)], -1)
                         .reshape(-1, 3))
    p1 = se3.act(se3.inv(T_21), p2)
    xy1 = torch.stack([DA_F * p1[:, 0] / p1[:, 2] + W / 2,
                       DA_F * p1[:, 1] / p1[:, 2] + H / 2], 1)
    da2_np = image.sample_bilinear(torch.as_tensor(da1_np), xy1).reshape(
        H, W).numpy()
    da1, da2 = on(da1_np), on(da2_np)
    depth = torch.full((DA_ARGS["k"],), DA_DEPTH, dtype=f32, device=dev)
    (T_est, res), ms, fps = phase(
        "path DA", lambda: direct.direct_pose_estimate(da1, da2, depth,
                                                       intr_da, **DA_ARGS),
        1, "frame pairs")
    T_ref, _ = direct.direct_pose_estimate(
        on(da1_np, cpu, f64), on(da2_np, cpu, f64),
        torch.full((DA_ARGS["k"],), DA_DEPTH, dtype=f64), intr_da,
        **DA_ARGS)
    T_card = se3.SE3(T_est.R.to(cpu, f64), T_est.t.to(cpu, f64))
    log_err = float(se3.local(T_card, T_21).abs().max())
    da_cpu = float(se3.local(T_card, T_ref).abs().max())
    _log("path DA", f"{H}x{W} f32, {DA_ARGS}: {res.iterations} LM "
                    f"iterations, cost {float(res.cost):.4e}; max |log "
                    f"error| {log_err:.3e} (gate {DA_LOG_ERR}); vs CPU f64 "
                    f"{da_cpu:.3e} (tol {DA_CPU_TOL})")
    if not (log_err < DA_LOG_ERR and da_cpu < DA_CPU_TOL):
        raise AssertionError(f"path DA: log error {log_err}, vs CPU {da_cpu}")
    phases["DA"] = {"ms": ms, "frame_pairs_per_s": fps, "iters":
                    res.iterations, "log_err": log_err, "vs_cpu": da_cpu}

    # ---- ORB: two frames 30 degrees apart, n 1000, matched ----
    orb_np = images.polygon_image(seed=FE_SEED, H=H, W=W,
                                  n_shapes=ORB_SHAPES)
    rot_np, M = images.rotate_image(orb_np, ORB_DEG)
    o1, o2 = on(orb_np), on(rot_np)

    def run_orb(a=o1, b=o2):
        fa, fb = orb.orb_detect(a, n=ORB_N), orb.orb_detect(b, n=ORB_N)
        return fa, fb, orb.orb_match(fa, fb, **ORB_MATCH)

    (fa, fb, (idx2, ok)), ms, fps = phase("path ORB", run_orb, 2, "frames")
    ok = ok.cpu().numpy()
    pred = fa.xy.cpu().numpy()[ok] @ M[:, :2].T + M[:, 2]
    err = np.linalg.norm(pred - fb.xy.cpu().numpy()[idx2.cpu().numpy()[ok]],
                         axis=1)
    frac = float((err < 3.0).mean()) if len(err) else 0.0
    ra, _, _ = run_orb(on(orb_np, cpu, f64), on(rot_np, cpu, f64))
    key = {tuple(p): i for i, p in enumerate(ra.xy.long().tolist())}
    va = fa.valid.cpu().numpy()
    common = [(i, key[tuple(p)]) for i, p in enumerate(fa.xy.long().tolist())
              if va[i] and tuple(p) in key and bool(ra.valid[key[tuple(p)]])]
    keep = len(common) / max(int(va.sum()), 1)
    ci, cj = (np.array(c) for c in zip(*common))
    bits = float((fa.desc.cpu().numpy()[ci] != ra.desc.numpy()[cj]).mean())
    _log("path ORB", f"two {H}x{W} frames {ORB_DEG} deg apart, n {ORB_N}: "
                     f"{int(va.sum())}, {int(fb.valid.sum())} valid, "
                     f"{int(ok.sum())} matches (gate >= {ORB_MIN_MATCHES}), "
                     f"{frac:.4f} within 3 px (gate > {ORB_MIN_FRAC}); vs "
                     f"CPU f64: keypoints in common {keep:.4f} (tol >= "
                     f"{ORB_KEEP}), descriptor bits differing {bits:.4e} "
                     f"(tol {ORB_BITS})")
    if not (ok.sum() >= ORB_MIN_MATCHES and frac > ORB_MIN_FRAC
            and keep >= ORB_KEEP and bits < ORB_BITS):
        raise AssertionError(f"path ORB: {int(ok.sum())} matches, {frac}, "
                             f"keep {keep}, bits {bits}")
    phases["ORB"] = {"ms": ms, "frames_per_s": fps, "matches": int(ok.sum()),
                     "frac_within_3px": frac, "vs_cpu_keep": keep,
                     "vs_cpu_bits": bits}

    # ---- CB: chessboard detection on a rendered, rotated board ----
    cb_np, truth = images.render_chessboard(shape=FE_SHAPE, **CB_BOARD)
    cb_img = on(cb_np)
    (boards, cxy, csc, _), ms, fps = phase(
        "path CB", lambda: chessboard.detect_chessboard(cb_img, device=dev),
        1, "frames")
    kept = np.isfinite(csc.cpu().numpy())
    det = cxy.cpu().numpy()[kept]
    best = np.linalg.norm(det[None] - truth[:, None], axis=2).min(axis=1)
    grid = cxy.cpu().numpy()[boards[0]] if boards else np.zeros((0, 0, 2))
    held = (np.linalg.norm(grid.reshape(-1, 1, 2) - truth[None], axis=2)
            .min(axis=0) < CB_PX) if boards else np.zeros(len(truth), bool)
    rboards, rxy, rsc, _ = chessboard.detect_chessboard(
        cb_np.astype(np.float64), device=cpu)
    rkept = np.isfinite(rsc.numpy())
    pair = np.linalg.norm(det[:, None] - rxy.numpy()[rkept][None], axis=2)
    cb_cpu = float(pair.min(axis=1).max()) if len(det) else np.inf
    same_board = bool(boards and rboards
                      and boards[0].shape == rboards[0].shape)
    _log("path CB", f"{H}x{W} board of {len(truth)} interior corners: "
                    f"{int(kept.sum())} kept, worst true corner "
                    f"{best.max():.4f} px (gate {CB_PX}); board "
                    f"{boards[0].shape if boards else None} holds "
                    f"{int(held.sum())} of them; vs CPU f64 {int(rkept.sum())}"
                    f" kept, corners within {cb_cpu:.3e} px (tol "
                    f"{CB_CPU_TOL}), same board shape {same_board}")
    if not ((best < CB_PX).all() and held.all()
            and boards[0].size == len(truth) and kept.sum() == rkept.sum()
            and cb_cpu < CB_CPU_TOL and same_board):
        raise AssertionError("path CB: a gate failed")
    phases["CB"] = {"ms": ms, "frames_per_s": fps, "kept": int(kept.sum()),
                    "worst_px": float(best.max()), "vs_cpu_px": cb_cpu}

    # ---- PAN: three overlapping VGA crops stitched, Harris and ORB ----
    dx = max(x for x, _ in PAN_CROPS)
    dy = max(y for _, y in PAN_CROPS)
    base = 0.5 * (images.textured_image(H + dy, W + dx, seed=FE_SEED)
                  + images.polygon_image(seed=FE_SEED, H=H + dy, W=W + dx,
                                         n_shapes=ORB_SHAPES))
    crops = [np.ascontiguousarray(base[y:y + H, x:x + W])
             for x, y in PAN_CROPS]
    corners = np.array([[0, 0], [W, 0], [0, H], [W, H]], np.float64)
    pan_out = {}
    for feat in ("harris", "orb"):
        (canvas, cover), ms, fps = phase(
            f"path PAN_{feat}", lambda: panorama.stitch(crops, seed=0,
                                                        device=dev,
                                                        features=feat),
            len(crops), "frames")
        canvas_err = _canvas_err(canvas.cpu().numpy(), cover.cpu().numpy(),
                                 base)
        worst, worst64, worst_cpu, n_min = 0.0, 0.0, 0.0, None
        g = torch.Generator(device=dev).manual_seed(0)
        g_cpu = torch.Generator().manual_seed(0)
        at = on(corners, cpu, f64)
        fns = dict(min_fit=panorama.homography_min_fit,
                   residual_sq=panorama.homography_residual_sq,
                   inlier_thresh_sq=4.0)
        for (x0, y0), (x1, y1), a, b in zip(PAN_CROPS, PAN_CROPS[1:], crops,
                                            crops[1:]):
            Hc, n_in = panorama.pairwise_homography(g, on(a), on(b),
                                                    features=feat)
            Hr, _ = panorama.pairwise_homography(
                g_cpu, on(a, cpu, f64), on(b, cpu, f64), features=feat)
            shift = on(corners - [x1 - x0, y1 - y0], cpu, f64)
            worst = max(worst, float((panorama.apply_h(Hc.to(cpu, f64), at)
                                      - shift).abs().max()))
            worst64 = max(worst64, float((panorama.apply_h(Hr, at) - shift)
                                         .abs().max()))
            n_min = int(n_in) if n_min is None else min(n_min, int(n_in))
            # the same subsets through the card's and the CPU's f64 data
            d_card = panorama.homography_matches(on(a, dev, f64),
                                                 on(b, dev, f64),
                                                 features=feat)
            d_cpu = panorama.homography_matches(on(a, cpu, f64),
                                                on(b, cpu, f64),
                                                features=feat)
            idx = draw_subsets(g_cpu, d_cpu["w"].shape[0], 256, 5,
                               sample_weights=d_cpu["w"])
            pc, sc = hypothesis_scores(d_card, idx.to(dev), **fns)
            pr, sr = hypothesis_scores(d_cpu, idx, **fns)
            good = sr > PAN_MIN_INLIERS
            if not (torch.equal(d_card["w"].cpu(), d_cpu["w"])
                    and torch.equal(sc.cpu(), sr) and bool(good.any())):
                raise AssertionError(f"path PAN {feat}: the card's matches "
                                     f"or inlier counts differ from the CPU's")
            for hc, hr in zip(pc.cpu()[good], pr[good]):
                worst_cpu = max(worst_cpu, float(
                    (panorama.apply_h(hc.reshape(3, 3), at)
                     - panorama.apply_h(hr.reshape(3, 3), at)).abs().max()))
        _log(f"path PAN_{feat}", f"3 crops {H}x{W} at {PAN_CROPS}: canvas "
                                 f"{tuple(canvas.shape)}, mean |canvas - base| "
                                 f"{canvas_err:.3e} (tol {PAN_CANVAS_TOL});"
                                 f" pairwise H f32 off the shift by "
                                 f"{worst:.4f} px at the corners (gate "
                                 f"{PAN_PX}; f64 {worst64:.3e}), fewest "
                                 f"inliers {n_min} (gate > "
                                 f"{PAN_MIN_INLIERS}); card f64 vs CPU f64 "
                                 f"on the same subsets: matches and counts "
                                 f"equal, good fits {worst_cpu:.3e} px (tol "
                                 f"{PAN_CPU_PX})")
        if not (canvas_err < PAN_CANVAS_TOL and worst < PAN_PX
                and n_min > PAN_MIN_INLIERS and worst_cpu < PAN_CPU_PX):
            raise AssertionError(f"path PAN {feat}: a gate failed")
        pan_out[feat] = {"ms": ms, "frames_per_s": fps, "shift_err_px": worst,
                         "shift_err_px_f64": worst64, "min_inliers": n_min,
                         "vs_cpu_px": worst_cpu, "canvas_err": canvas_err}
    phases["PAN"] = pan_out
    wall = time.perf_counter() - t_start
    _log("frontend", f"paths FO, SD, LK, DA, ORB, CB and PAN with their CPU "
                     f"references: {wall:.1f} s of wall time")
    phases["frontend"] = {"wall_s": wall}
    return {"launches": launches_of}


# ---- slice H: the example programs (paths ex_*) ----

EX_KERNELS = {              # the kernels each example must launch on the card
    "ex_ba": ("spd_solve",), "ex_calibration": ("spd_solve",),
    "ex_incremental": ("ba_assemble", "tridiag_solve"), "ex_pnp": (),
    "ex_sim3": ("spd_solve",),
    "ex_trajectory": ("ba_assemble", "tridiag_solve"),
    "ex_two_view": ("ba_assemble", "spd_solve"), "ex_vi": ("spd_solve",)}
EX_ATE_RATIO = 0.5          # ex_ba, ex_trajectory: ATE below this x the
#                             perturbed start's (JAX CPU runs: 0.31 and 0.32)
EX_PNP_COST_MAX = M_COST_MAX    # ex_pnp: every cost, noiseless f32 data
EX_PNP_POSE_ERR = 1e-4      # ex_pnp: R and t against the truth, f32
EX_TV_CHEIRAL = 100         # ex_two_view: every point in front of both
EX_VI_INIT_SCALE_ERR = 0.05     # ex_vi: vi_initialize's |scale - 1| (the
#                                 JAX example on the CPU: 1.015)
EX_CPU_RTOL = {             # card (f32) against the CPU (f64; ex_vi f32),
    "ex_ba": 2e-4,          # max |card - cpu| / |cpu| over the numbers named
    "ex_calibration": 1e-4,     # in EX_CPU_KEYS: ~3-4x what three H100 runs
    "ex_two_view": 1e-3,        # read, the same in each (5.0e-5, 3.4e-5,
    "ex_sim3": 7e-4,            # 2.3e-4, 1.7e-4, 8.6e-4)
    "ex_vi": 3.5e-3}
EX_CPU_KEYS = {
    "ex_ba": ("initial_ate", "final_ate", "final_cost", "reprojection_rms"),
    "ex_calibration": ("fx", "fy", "cx", "cy", "rms_px"),
    "ex_two_view": ("rot_err", "t_err", "depth_err_median", "depth_err_max",
                    "final_cost"),
    "ex_sim3": ("drift_ate", "sim3_ate", "scale_err", "sim3_cost", "se3_ate",
                "se3_cost"),
    "ex_vi": ("dead_reckoning_ate", "observation_ate", "smoother_ate",
              "bias_err", "vi_ba_scale", "vi_init_scale")}
EX_TIMER_RTOL = 0.1         # Timer.lap(sync=) against CUDA events around the
EX_TIMER_SLACK_MS = 5.0     # same call: events x (1 -+ this) (+ this ms);
EX_TIMER_N = 8192           # the call: 8 f32 products of N^2 (~130 ms)
EX_CAPTURE_PER_SHAPE = 2    # kept calls of a kernel at a shape: its second
#                             is an LM loop's first step, past the start


def examples_paths(dev, run_phase, check_spd, check_assemble, phases):
    """The eight runnable example programs (slam_tricks_tpu_torch.examples:
    ba, calibration, incremental, pnp, sim3_posegraph, trajectory_ba,
    two_view, vi_smoother; kitti_vo needs frames the card machine lacks) at
    their default sizes through their ``run``, float32 on the card, each
    with every launch count set to 0 just before it (run_phase), each
    launching the kernels of EX_KERNELS (ex_pnp none) and gated on its own
    outcome; the six small ones also on the CPU (in float64, ex_vi float32)
    and held to it (EX_CPU_RTOL). That one card run of each example also
    captures its kernels' inputs (captured_calls, the first
    EX_CAPTURE_PER_SHAPE calls at each shape, every call counted): every
    launch must be a captured call, and each kernel is held against its
    plain version at every shape the example gave it (the last captured
    call there), timed beside its bound and the library. The host
    utilities on the card: ex_two_view under ``utils.timer.profile_trace``
    with an ``annotate`` region (the trace must name it), ex_ba's final
    BAState through ``save_pytree`` / ``load_pytree`` onto the card (the
    same bits), and ``Timer.lap(sync=)`` against CUDA events. Returns
    {"spd": {label: numbers}, "assemble": {label: numbers}, "tridiag":
    {label: numbers}, "launches": {path: counts}}."""
    import tempfile

    import torch

    from slam_tricks_tpu_torch.examples import (ba_demo, calibration_demo,
                                                incremental_demo, pnp_demo,
                                                sim3_posegraph_demo,
                                                trajectory_ba_demo,
                                                two_view_demo,
                                                vi_smoother_demo)
    from slam_tricks_tpu_torch.solvers import (banded_flat, common,
                                               posegraph, schur,
                                               schur_flat_sm)
    from slam_tricks_tpu_torch.utils import checkpoint, timer

    modules = {"ex_ba": ba_demo, "ex_calibration": calibration_demo,
               "ex_incremental": incremental_demo, "ex_pnp": pnp_demo,
               "ex_sim3": sim3_posegraph_demo,
               "ex_trajectory": trajectory_ba_demo,
               "ex_two_view": two_view_demo, "ex_vi": vi_smoother_demo}
    # where each example's solvers call the kernels' wrappers
    banded = [(banded_flat, "linearize_assemble"),
              (banded_flat, "tridiag_solve")]
    targets = {"ex_ba": [(schur, "spd_solve")],
               "ex_calibration": [(common, "spd_solve")],
               "ex_incremental": banded, "ex_pnp": [],
               "ex_sim3": [(posegraph, "spd_solve")],
               "ex_trajectory": banded,
               "ex_two_view": [(schur_flat_sm, "linearize_assemble"),
                               (schur_flat_sm, "spd_solve")],
               "ex_vi": [(common, "spd_solve")]}
    kernel_of = {"linearize_assemble": "ba_assemble",
                 "spd_solve": "spd_solve", "tridiag_solve": "tridiag_solve"}
    t_start = time.perf_counter()
    spd, asm, tri, launches_of, results, captured = {}, {}, {}, {}, {}, {}

    def args_of(name, cpu):
        return modules[name].build_parser().parse_args(["--cpu"] if cpu
                                                       else [])

    def numbers(out):
        """The numbers of an example's returned dict (not its tensors)."""
        return {k: v for k, v in out.items()
                if isinstance(v, (int, float, list, tuple))
                and not hasattr(v, "_fields")}

    for name, mod in modules.items():
        counts = {}
        *calls, out = captured_calls(
            targets[name], lambda: run_phase(
                name, lambda costs: mod.run(args_of(name, False)),
                iters_of=lambda o: 1),
            per_shape=EX_CAPTURE_PER_SHAPE, counts=counts)
        out, _, launches, ms = out
        missing = [k for k in EX_KERNELS[name] if launches[k] < 1]
        if missing or (not EX_KERNELS[name] and any(launches.values())):
            raise AssertionError(f"{name}: launches {launches}, needs "
                                 f"{EX_KERNELS[name] or 'none'}")
        seen = {k: 0 for k in launches}
        for (_, fname), by_shape in counts.items():
            seen[kernel_of[fname]] += sum(by_shape.values())
        if seen != launches:
            raise AssertionError(f"{name}: launches {launches}, but the "
                                 f"captured wrappers were called {seen}")
        _log(name, f"{ms:.1f} ms (CUDA events around run(), the host's "
                   f"set-up and the capture's copies included); launches "
                   f"{launches}; {json.dumps(numbers(out))}")
        launches_of[name] = launches
        results[name] = out
        captured[name] = [(t, c, counts[t])
                          for t, c in zip(targets[name], calls)]
        phases[name] = {"ms": ms, "launches": launches, **numbers(out)}
    if results["ex_calibration"]["dataset"] != "synthetic":
        raise AssertionError("ex_calibration ran on corner files, not on the "
                             "synthetic scene its gates are for")

    # ---- gates: each example's own outcome ----
    r = results
    costs = [*r["ex_ba"]["costs"], r["ex_calibration"]["rms_px"],
             r["ex_incremental"]["init_cost"],
             *(c for _, c, _ in r["ex_incremental"]["arrivals"]),
             r["ex_incremental"]["warm_cost"],
             r["ex_incremental"]["batch_cost"], r["ex_pnp"]["lm_cost"],
             r["ex_pnp"]["gn_cost"], r["ex_pnp"]["analytic_cost"],
             r["ex_pnp"]["batch_max_cost"], r["ex_sim3"]["sim3_cost"],
             r["ex_sim3"]["se3_cost"], r["ex_trajectory"]["cost"],
             r["ex_two_view"]["final_cost"]]
    gates = {
        "every cost finite": all(math.isfinite(c) for c in costs),
        "ex_ba costs non-increasing": all(
            b <= a for a, b in zip(r["ex_ba"]["costs"],
                                   r["ex_ba"]["costs"][1:])),
        f"ex_ba ATE < {EX_ATE_RATIO} x start": (
            r["ex_ba"]["final_ate"]
            < EX_ATE_RATIO * r["ex_ba"]["initial_ate"]),
        f"ex_calibration |fx - 600|, |fy - 590| < {Z_F_ERR}": (
            abs(r["ex_calibration"]["fx"] - GEO_Z_FX) < Z_F_ERR
            and abs(r["ex_calibration"]["fy"] - GEO_Z_FY) < Z_F_ERR),
        f"ex_calibration RMS < {Z_RMS_MAX} px": (
            r["ex_calibration"]["rms_px"] < Z_RMS_MAX),
        "ex_incremental rebatched ATE < streamed": (
            r["ex_incremental"]["warm_ate"]
            < r["ex_incremental"]["stream_ate"]),
        f"ex_pnp costs < {EX_PNP_COST_MAX}": max(
            r["ex_pnp"][k] for k in ("lm_cost", "gn_cost", "analytic_cost",
                                     "batch_max_cost")) < EX_PNP_COST_MAX,
        f"ex_pnp poses within {EX_PNP_POSE_ERR}": max(
            r["ex_pnp"]["pose_err"], r["ex_pnp"]["batch_pose_err"])
        < EX_PNP_POSE_ERR,
        f"ex_sim3 scale error < {PG_S_SCALE_ERR}": (
            r["ex_sim3"]["scale_err"] < PG_S_SCALE_ERR),
        f"ex_sim3 ATE < {PG_S_ATE_RATIO} x the drifted map's": (
            r["ex_sim3"]["sim3_ate"]
            < PG_S_ATE_RATIO * r["ex_sim3"]["drift_ate"]),
        f"ex_trajectory ATE < {EX_ATE_RATIO} x start": (
            r["ex_trajectory"]["ate"]
            < EX_ATE_RATIO * r["ex_trajectory"]["ate0"]),
        "ex_trajectory covariances finite": r["ex_trajectory"]["cov_finite"],
        f"ex_two_view cheirality {EX_TV_CHEIRAL}": (
            r["ex_two_view"]["n_cheiral"] == EX_TV_CHEIRAL),
        "ex_vi smoother ATE < the observations'": (
            r["ex_vi"]["smoother_ate"] < r["ex_vi"]["observation_ate"]),
        "ex_vi bias error falls": r["ex_vi"]["bias_err"]
        < r["ex_vi"]["bias_err0"],
        f"ex_vi VI-BA |scale - 1| < {N_SCALE_ERR}": (
            abs(r["ex_vi"]["vi_ba_scale"] - 1.0) < N_SCALE_ERR),
        f"ex_vi vi_initialize |scale - 1| < {EX_VI_INIT_SCALE_ERR}": (
            abs(r["ex_vi"]["vi_init_scale"] - 1.0) < EX_VI_INIT_SCALE_ERR)}
    failed = [g for g, ok in gates.items() if not ok]
    _log("examples", f"gates: {len(gates) - len(failed)} of {len(gates)} "
                     f"passed" + (f"; failed: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"examples: gates failed: {failed}")

    # ---- the six small examples on the CPU, card against CPU ----
    for name in EX_CPU_RTOL:
        t0 = time.perf_counter()
        cpu = modules[name].run(args_of(name, True))
        cpu_s = time.perf_counter() - t0
        worst = max(abs(r[name][k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
                    for k in EX_CPU_KEYS[name])
        _log(name, f"card against the CPU ({cpu_s:.1f} s there): worst "
                   f"relative difference {worst:.3e} over "
                   f"{EX_CPU_KEYS[name]} (tol {EX_CPU_RTOL[name]})")
        if not worst <= EX_CPU_RTOL[name]:
            raise AssertionError(f"{name}: card against CPU {worst}")
        phases[name]["vs_cpu"] = worst
    pnp_cpu = pnp_demo.run(args_of("ex_pnp", True))
    pnp_worst = max(pnp_cpu["pose_err"], pnp_cpu["batch_pose_err"],
                    r["ex_pnp"]["pose_err"], r["ex_pnp"]["batch_pose_err"])
    _log("ex_pnp", f"card f32 and CPU f64 both at the truth: largest pose "
                   f"error {pnp_worst:.3e} (tol {EX_PNP_POSE_ERR}); CPU "
                   f"costs {pnp_cpu['lm_cost']:.3e}, "
                   f"{pnp_cpu['batch_max_cost']:.3e}")
    if not pnp_worst < EX_PNP_POSE_ERR:
        raise AssertionError(f"ex_pnp: card against CPU {pnp_worst}")
    phases["ex_pnp"]["vs_cpu"] = pnp_worst

    # ---- each kernel against plain at every shape an example gave it ----
    for name, per_target in captured.items():
        for (_, fname), calls, by_shape in per_target:
            last = {_shape_key(c): c for c in calls}
            for key, c in last.items():
                n_calls = by_shape[key]
                if fname == "spd_solve":
                    label = (f"{name}_n{c[0].shape[0]}_"
                             f"{str(c[0].dtype).rsplit('.', 1)[1]}")
                    spd[label] = {**check_spd(*c[:2], label),
                                  "launches": n_calls}
                elif fname == "tridiag_solve":
                    G, m = c[2].shape[:2]
                    q = c[2].shape[2] if c[2].dim() == 3 else 1
                    label = f"{name}_G{G}_m{m}_q{q}"
                    tri[label] = {**check_tridiag_many(
                        *(a.contiguous() for a in c[:3]), label, timed=True),
                        "launches": n_calls}
                else:
                    # kernel and plain each held to plain in float64 of the
                    # same inputs (ref64): near tukey(0.02)'s threshold and
                    # at a two-view start (each landmark at its rays'
                    # midpoint) float32's own rounding moves gl by more
                    # than ASSEMBLE_REL_TOL
                    K, L = c[5].shape
                    label = f"{name}_C{c[0].shape[0]}_K{K}_L{L}"
                    asm[label] = {**dict(zip(
                        ("err", "ms", "plain_ms", "device_ms", "bound_ms",
                         "bound_by"),
                        check_assemble(c[:7], c[7], label, c[8],
                                       ref64=True))),
                        "grid": [K, L], "launches": n_calls,
                        "loss": None if c[8] is None
                        else f"{c[8].kind}({c[8].param:g})"}
    del captured, calls, last, c

    # ---- the host utilities on the card ----
    with tempfile.TemporaryDirectory() as tmp:
        with timer.profile_trace(tmp):
            with timer.annotate("ex_two_view"):
                two_view_demo.run(args_of("ex_two_view", False))
        trace = Path(tmp) / "trace.json"
        text = trace.read_text() if trace.is_file() else ""
        n_kernels = text.count('"cat": "kernel"')
        _log("utils.timer", f"profile_trace of ex_two_view: {trace.name} "
                            f"{len(text)} bytes, names the annotate region: "
                            f"{'ex_two_view' in text}, CUDA kernel events "
                            f"{n_kernels}")
        if "ex_two_view" not in text or n_kernels < 1:
            raise AssertionError("profile_trace: no trace naming the region "
                                 "with CUDA kernels")
        state = results["ex_ba"]["state"]
        path = checkpoint.save_pytree(str(Path(tmp) / "ba_state.npz"), state)
        back = checkpoint.load_pytree(path, state)
    leaves, leaves_back = (checkpoint.tree_leaves(state),
                           checkpoint.tree_leaves(back))
    same = len(leaves) == len(leaves_back) and all(
        torch.equal(a, b) and b.is_cuda if isinstance(a, torch.Tensor)
        else a == b for a, b in zip(leaves, leaves_back))
    _log("utils.checkpoint", f"ex_ba's BAState through save_pytree / "
                             f"load_pytree onto {back.points.device}: the "
                             f"same bits in every leaf: {same}")
    if not same:
        raise AssertionError("checkpoint: the BAState came back changed")

    busy = torch.ones((EX_TIMER_N, EX_TIMER_N), device=dev)
    work = lambda: [busy @ busy for _ in range(8)][-1]  # noqa: E731
    work()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = timer.Timer()
    start.record()
    out = work()
    end.record()
    lap_ms = t.lap("matmuls", sync=out) * 1e3
    event_ms = start.elapsed_time(end)
    _log("utils.timer", f"Timer.lap(sync=) {lap_ms:.3f} ms against CUDA "
                        f"events {event_ms:.3f} ms around the same 8 "
                        f"products of {EX_TIMER_N}^2")
    if not (event_ms * (1 - EX_TIMER_RTOL) <= lap_ms
            <= event_ms * (1 + EX_TIMER_RTOL) + EX_TIMER_SLACK_MS):
        raise AssertionError(f"Timer.lap {lap_ms} ms, events {event_ms} ms")
    phases["utils"] = {"timer_lap_ms": lap_ms, "timer_event_ms": event_ms,
                       "trace_kernel_events": n_kernels,
                       "checkpoint_same_bits": same}
    del busy, out, results, state, back
    wall = time.perf_counter() - t_start
    _log("examples", f"paths ex_* with their CPU runs and kernel checks: "
                     f"{wall:.1f} s of wall time")
    phases["examples"] = {"wall_s": wall}
    return {"spd": spd, "assemble": asm, "tridiag": tri,
            "launches": launches_of}


# ---- slice G: the distributed solvers, two gloo ranks on one card ----

DIST_RANKS = 2              # rank processes, all on cuda:0 (gloo: NCCL
#                             refuses two ranks on one device)
DIST_PG_TIMEOUT_S = 300.0   # a collective that waits longer raises
DIST_JOIN_TIMEOUT_S = 600.0     # the ranks' whole run, set-up included
DIST_FIRST_REL_TOL = 5e-5   # the first accepted step's cost against the
#                             single-process path's, f32, at the paths' own
#                             sizes: the H100 read 1.0e-7 (B), 1.8e-6 (L)
#                             and 1.4e-6 (A), the CPU's plain versions up to
#                             2.6e-5 (B); only the summation order across
#                             ranks differs
DIST_PCG_FIRST_REL_TOL = 2e-4   # dist_pcg's: CG in f32 stops on a residual
#                             at its noise floor, so its step moves more
#                             with the order (the H100 2.1e-5, the CPU 5.3e-5
#                             at B's size)
DIST_PAD_SCENE = dict(n_cams=16, n_points=240, track_len=4, seed=73)
DIST_PAD_RANKS = 3          # tests/test_torch_parallel_solvers.py's uneven
#                             split: the last slice holds pad chunks


def _dist_rank(rank, world, tmpdir, device):
    """One rank of dist_paths, a spawned process on `device`: joins the gloo
    group through tmpdir's file store, loads the kernel library the parent
    built, and runs each path of tmpdir/payload.pt (moved to the card,
    timed apart; a 2-iteration warm-up, in which rank 0 captures the
    tensors of the first call of the path's `capture` (solver module,
    kernel wrapper) when it names one; then the solve with every launch
    count set to 0, CUDA events around it and each all_reduce's operand
    recorded). Writes its results to tmpdir/rank<rank>.pt, or its
    traceback to rank<rank>.err."""
    import importlib
    import traceback

    import torch
    import torch.distributed as dist

    tmp = Path(tmpdir)
    try:
        sys.path.insert(0, str(ROOT))
        from slam_tricks_tpu_torch.ops import (_build, ba_assemble, spd_solve,
                                               tridiag_solve, undistort)
        from slam_tricks_tpu_torch.parallel import multihost
        from slam_tricks_tpu_torch.solvers.common import set_full_precision

        ops = (ba_assemble, spd_solve, tridiag_solve, undistort)
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        set_full_precision()
        multihost.initialize_multihost(f"file://{tmp / 'store'}", world, rank,
                                       timeout_s=DIST_PG_TIMEOUT_S)
        group = multihost.global_obs_mesh()
        _build.library()            # the parent's build, loaded
        out = {}
        for name, make, kw, args, capture in torch.load(
                tmp / "payload.pt", weights_only=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            args = multihost.make_global_array(args, group, dev)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            warm = make(group, **{**kw, "max_iters": 2})
            captured = None
            if capture is not None and rank == 0:
                mod = importlib.import_module(
                    f"slam_tricks_tpu_torch.solvers.{capture[0]}")
                calls_, _ = captured_calls([(mod, capture[1])],
                                           lambda: warm(*args))
                captured = tuple(a.cpu() for a in calls_[0]
                                 if isinstance(a, torch.Tensor))
            else:
                warm(*args)
            solve = make(group, **kw)
            torch.cuda.synchronize()
            _reset_counts(*ops)
            costs, calls = [], []
            real = dist.all_reduce

            def counted(t, *a, **k):
                calls.append((t.numel(), t.numel() * t.element_size()))
                return real(t, *a, **k)

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            dist.all_reduce = counted
            try:
                start.record()
                state = solve(*args, costs=costs)
                end.record()
                end.synchronize()
            finally:
                dist.all_reduce = real
            out[name] = {
                "it": state.it, "costs": [float(c) for c in costs],
                "R": state.poses.R.cpu(), "t": state.poses.t.cpu(),
                "points": state.points.cpu(), "cost": state.cost.cpu(),
                "ms": start.elapsed_time(end) / max(state.it, 1),
                "setup_s": setup_s, "calls": calls, "captured": captured,
                "launches": {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES
                             for m in ops}}
            del args, state
        torch.save(out, tmp / f"rank{rank}.pt")
    except BaseException:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dist_paths(dev, scenes, singles, check_assemble, check_spd, phases):
    """Slice G: the distributed solvers (slam_tricks_tpu_torch.parallel) on
    DIST_RANKS gloo ranks that share the card, each path at full width and
    set beside its single-process path of this run:

    - dist_banded: make_ba_solver_banded_dist on path B's scene, 12
      iterations (ba_assemble on each rank's chunks, tridiag_solve
      replicated);
    - dist_loop: make_ba_solver_loop_dist on path L's scene, max_band 8,
      12 iterations (the loop-closure part replicated);
    - dist_pcg: make_ba_solver_pcg_dist on path B's scene, path P's 5
      iterations and CG settings;
    - dist_sharded and dist_lmlocal: make_ba_solver and
      make_ba_solver_landmark_local on path A's scene, 20 iterations
      (spd_solve replicated at n = 576).

    scenes: {"A", "B", "L": (obs, poses0, points0, fixed)}, the very inputs
    of those paths; singles: {"A", "B", "L", "P": that path's costs}. The
    works are built here on the host, once, and handed to the ranks (a
    file in a temporary directory); the kernel library is built before
    (the ranks only load it). Gates, each path: the ranks' final poses,
    points, cost and costs the same bits; the single-process path's
    iteration count; its first accepted step's cost within
    DIST_FIRST_REL_TOL (dist_pcg: DIST_PCG_FIRST_REL_TOL); its final-cost
    gate; every kernel of the path
    launched on every rank; on rank 0 the largest all_reduce operand of
    the banded, loop and PCG paths (the final gather of the points, once a
    solve, apart) within the JAX tests' pose-sized caps. Then each kernel
    against plain, timed, at every grid the ranks gave it: ba_assemble at
    rank 0's slice of B's grid (dist_banded), at rank 0's slice of L's
    single-run grid and at rank 0's landmark-local flat grid (the first
    calls of dist_loop and dist_pcg, captured on rank 0), where the
    cameras with no live slot on the rank must get exact zeros, and at
    the last, pad-heavy slice of a DIST_PAD_RANKS-way split of
    DIST_PAD_SCENE (untimed); spd_solve at the replicated system of
    dist_sharded's first step (captured on rank 0). A rank that fails,
    hangs past DIST_JOIN_TIMEOUT_S or disagrees fails the run. Returns
    {"launches": {path: counts summed over the ranks}, "assemble": {label:
    numbers}, "spd": {label: numbers}}."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from slam_tricks_tpu_torch.ops import ba_assemble
    from slam_tricks_tpu_torch.parallel import (banded_dist, landmark_local,
                                                loop_dist, partition,
                                                pcg_dist, sharded_ba)
    from slam_tricks_tpu_torch.parallel.multihost import make_global_array
    from slam_tricks_tpu_torch.sim import make_trajectory_scene, perturb_scene

    t_start = time.perf_counter()
    D = DIST_RANKS
    f32 = torch.float32
    cpu = lambda x: make_global_array(x, None, "cpu")  # noqa: E731
    obs_a, *state_a = cpu(scenes["A"])
    obs_b, *state_b = cpu(scenes["B"])
    obs_l, *state_l = cpu(scenes["L"])
    C_b = state_b[0].t.shape[0]
    L_a, L_b, L_l = (s[1].shape[0] for s in (state_a, state_b, state_l))
    C_l = state_l[0].t.shape[0]

    t0 = time.perf_counter()
    work_b = banded_dist.build_dist_banded_work(obs_b, C_b, L_b, D,
                                                dtype=f32)
    work_l = loop_dist.build_dist_loop_work(obs_l, C_l, L_l, D, dtype=f32,
                                            max_band=8)
    work_p = pcg_dist.build_dist_work(
        partition.partition_obs_by_landmark(obs_b, D), C_b, L_b, D,
        dtype=f32)
    part_a = partition.partition_obs_by_landmark(obs_a, D)
    pairs_a = partition.build_local_pairs(part_a, D, dtype=f32)
    setup_s = time.perf_counter() - t0
    K_b = work_b.local[0].w.shape[0]
    K_l = work_l.banded_local[0].w.shape[0]
    banded_cap = lambda K, C: K * C * 36 * 4 * 2  # noqa: E731
    # (name, single path, make, kwargs, args, kernels, final-cost gate,
    #  all_reduce cap in bytes or None, the final gather's values or None,
    #  the (solver module, kernel wrapper) whose first call rank 0
    #  captures for a kernel check, or None)
    specs = [
        ("dist_banded", "B", banded_dist.make_ba_solver_banded_dist,
         dict(max_iters=12), (state_b[0], state_b[1], work_b, state_b[2]),
         ("ba_assemble", "tridiag_solve"), B_FINAL_COST_MAX,
         banded_cap(K_b, C_b), 4 * L_b, None),
        ("dist_loop", "L", loop_dist.make_ba_solver_loop_dist,
         dict(max_iters=12), (state_l[0], state_l[1], work_l, state_l[2]),
         ("ba_assemble",), B_FINAL_COST_MAX, banded_cap(K_l, C_l), 4 * L_l,
         ("banded_flat", "linearize_assemble")),
        ("dist_pcg", "P", pcg_dist.make_ba_solver_pcg_dist,
         dict(max_iters=5, cg_iters=50, cg_tol=1e-6),
         (state_b[0], state_b[1], work_p, state_b[2]), ("ba_assemble",),
         P_FINAL_COST_MAX, C_b * 6 * 6 * 4 * 2, 4 * L_b,
         ("schur_flat_sm", "linearize_assemble")),
        ("dist_sharded", "A", sharded_ba.make_ba_solver, dict(max_iters=20),
         (state_a[0], state_a[1], part_a, pairs_a, state_a[2]),
         ("spd_solve",), FINAL_COST_MAX, None, None, ("schur", "spd_solve")),
        ("dist_lmlocal", "A", landmark_local.make_ba_solver_landmark_local,
         dict(max_iters=20),
         (state_a[0], state_a[1], part_a, pairs_a, state_a[2]),
         ("spd_solve",), FINAL_COST_MAX, None, 4 * L_a, None),
    ]
    _log("dist", f"{D} ranks: the works of paths B ({len(work_b.local)} "
                 f"slices of {work_b.local[0].w.shape[1]} slots, K={K_b}), "
                 f"L (K={K_l}, {work_l.lc.lc_w.shape[1]} loop-closure "
                 f"slots replicated), P (local grids "
                 f"{tuple(work_p.flat[0].slot.w.shape)}) and A "
                 f"({part_a.cam_idx.shape[0] // D} rows a rank) built on the "
                 f"host in {setup_s:.2f} s")

    # the ranks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        torch.save([(name, make, kw, args, capture)
                    for name, _, make, kw, args, *_, capture in specs],
                   tmp / "payload.pt")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_dist_rank,
                             args=(rank, D, tmpdir, str(dev)))
                 for rank in range(D)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [(tmp / f"rank{r}.err").read_text() for r in range(D)
                  if (tmp / f"rank{r}.err").exists()]
        if hung or errors or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"dist: ranks hung {hung}, exit codes "
                                 f"{[p.exitcode for p in procs]}\n"
                                 + "\n".join(errors))
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(D)]
        ranks_s = time.perf_counter() - t0
    _log("dist", f"{D} rank processes ran every path in {ranks_s:.1f} s "
                 f"(spawn, group, loading the work and the library "
                 f"included)")

    launches = {}
    for (name, single, _, _, args, kernels, gate, cap, gather,
         _) in specs:
        r0 = ranks[0][name]
        for r, other in enumerate(ranks[1:], 1):
            o = other[name]
            same = (o["it"] == r0["it"] and o["costs"] == r0["costs"]
                    and all(torch.equal(o[k], r0[k])
                            for k in ("R", "t", "points", "cost")))
            if not same:
                raise AssertionError(f"{name}: rank {r} differs from rank 0")
        c = r0["costs"]
        _log(name, f"{r0['it']} LM iterations, cost {c[0]:.6e} -> "
                   f"{c[-1]:.6e}; {r0['ms']:.4f} ms per LM iteration on rank "
                   f"0 (CUDA events); set-up on the card "
                   f"{r0['setup_s']:.2f} s; ranks bitwise equal in poses, "
                   f"points, cost and every step's cost")
        _log(name, "costs " + " ".join(f"{v:.4e}" for v in c))
        _check_costs(c, gate, name)
        sc = singles[single]
        first = next(v for v in c[1:] if v < c[0])
        first_s = next(v for v in sc[1:] if v < sc[0])
        rel = abs(first - first_s) / first_s
        tol = (DIST_PCG_FIRST_REL_TOL if name == "dist_pcg"
               else DIST_FIRST_REL_TOL)
        _log(name, f"path {single} (one process): {len(sc) - 1} iterations, "
                   f"first accepted step's cost {first_s:.8e}, here "
                   f"{first:.8e}: rel {rel:.3e} (bound {tol})")
        if r0["it"] != len(sc) - 1 or not rel <= tol:
            raise AssertionError(f"{name}: {r0['it']} iterations against "
                                 f"{len(sc) - 1}, first step rel {rel} > "
                                 f"{tol}")
        C_, L_ = args[0].t.shape[0], args[1].shape[0]
        if (r0["R"].shape != (C_, 3, 3) or r0["points"].shape != (L_, 3)
                or not torch.isfinite(r0["points"]).all()
                or not torch.isfinite(r0["R"]).all()):
            raise AssertionError(f"{name} returned malformed or non-finite "
                                 f"state")
        by_rank = [rk[name]["launches"] for rk in ranks]
        if any(n[k] < 1 for n in by_rank for k in kernels):
            raise AssertionError(f"{name} skipped a kernel: {by_rank}")
        launches[name] = {k: sum(n[k] for n in by_rank) for k in by_rank[0]}
        calls = r0["calls"]
        loop_calls = [b for n, b in calls if n != gather]
        gathers = [b for n, b in calls if n == gather]
        it = max(r0["it"], 1)
        ar = {"calls": len(calls), "bytes": sum(b for _, b in calls),
              "calls_per_iter": len(loop_calls) / it,
              "bytes_per_iter": sum(loop_calls) / it,
              "max_operand_bytes": max(loop_calls), "cap_bytes": cap,
              "gather_bytes": sum(gathers)}
        _log(name, f"launches (both ranks) {launches[name]}, by rank "
                   f"{by_rank}; all_reduce on rank 0: {ar['calls']} calls, "
                   f"{ar['bytes']} bytes; an LM iteration "
                   f"{ar['calls_per_iter']:.1f} calls, "
                   f"{ar['bytes_per_iter']:.0f} bytes (the start's "
                   f"linearization included, the final gather of "
                   f"{ar['gather_bytes']} bytes not), largest operand "
                   f"{ar['max_operand_bytes']} bytes (cap {cap})")
        if gather is not None and len(gathers) != 1:
            raise AssertionError(f"{name}: {len(gathers)} gathers of the "
                                 f"points")
        if cap is not None and not ar["max_operand_bytes"] <= cap:
            raise AssertionError(f"{name}: an all_reduce of "
                                 f"{ar['max_operand_bytes']} bytes > {cap}")
        phases[name] = {"ms_per_lm_iter": r0["ms"], "iters": r0["it"],
                        "final_cost": c[-1], "first_step_rel": rel,
                        "launches": launches[name],
                        "launches_by_rank": by_rank, "all_reduce": ar,
                        "setup_host_s": setup_s,
                        "setup_card_s": r0["setup_s"]}

    # the kernels against plain at the ranks' grids
    def slice_args(bw, poses, points):
        bw = make_global_array(bw, None, dev)
        poses, points = make_global_array((poses, points), None, dev)
        return ((poses.R.reshape(bw.n_cams, 9).contiguous(), poses.t,
                 points[bw.gather_idx].contiguous(), bw.uv0, bw.uv1, bw.w,
                 bw.cam_of_slot), bw.cam_index)

    def captured_args(name):
        args_ = tuple(a.to(dev) for a in ranks[0][name]["captured"])
        return args_, ba_assemble.camera_index(args_[5], args_[6],
                                               args_[0].shape[0])

    sc = make_trajectory_scene(dtype=f32, device="cpu", **DIST_PAD_SCENE)
    # perturbed, as B's start: at the truth the residuals are zero and gp
    # is rounding alone, no measure of the kernel
    pad_state = perturb_scene(sc, pose_rot_noise=0.002,
                              pose_trans_noise=0.01, point_noise=0.01,
                              seed=DIST_PAD_SCENE["seed"] + 1)[:2]
    pad_work = banded_dist.build_dist_banded_work(
        sc.obs, sc.n_cams, sc.n_points, DIST_PAD_RANKS, dtype=f32).local[-1]
    asm = {}
    for label, path, (args_, index) in (
            ("dist_banded rank 0 slice", "dist_banded",
             slice_args(work_b.local[0], state_b[0], state_b[1])),
            ("dist_loop rank 0 slice", "dist_loop",
             captured_args("dist_loop")),
            ("dist_pcg rank 0 local grid", "dist_pcg",
             captured_args("dist_pcg")),
            ("pad-heavy slice", None, slice_args(pad_work, *pad_state))):
        timed = path is not None
        got = check_assemble(args_, index, label, timed=timed)
        out_k = ba_assemble.linearize_assemble(*args_, index)
        w, cam = args_[5], args_[6]
        C = args_[0].shape[0]
        seen = torch.zeros(C, dtype=torch.bool, device=dev)
        seen[cam[w > 0].long()] = True
        absent = int((~seen).sum())
        zeros = bool((out_k[0][~seen] == 0).all()
                     and (out_k[1][~seen] == 0).all())
        dead = int((w == 0).sum())
        pad = (None if timed else
               int((pad_work.scatter_idx >= pad_work.n_points).sum()))
        of_pad = "" if pad is None else f" ({pad} of pad chunks)"
        _log("ba_assemble", f"{label}: grid {tuple(w.shape)}, {dead} slots "
                            f"of weight 0{of_pad}, {absent} of {C} cameras "
                            f"with no live slot: their Hpp and gp rows exact "
                            f"zeros: {zeros}")
        if not zeros or (not timed and (absent == 0 or pad == 0)):
            raise AssertionError(f"ba_assemble {label}: {absent} cameras "
                                 f"without a slot, {pad} pad slots, their "
                                 f"rows zero: {zeros}")
        keys = ("err", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by")
        asm[label] = {**dict(zip(keys, got)), "grid": list(w.shape),
                      "dead_slots": dead, "cameras_without_slot": absent}
        if timed:
            asm[label]["launches"] = launches[path]["ba_assemble"]
        else:
            asm[label]["pad_slots"] = pad
    del out_k, args_, index

    S_, b_ = ranks[0]["dist_sharded"]["captured"]
    spd = {"dist_sharded_n576": {
        **check_spd(S_.to(dev), b_.to(dev), "dist_sharded replicated S"),
        "launches": launches["dist_sharded"]["spd_solve"]
        + launches["dist_lmlocal"]["spd_solve"]}}
    wall = time.perf_counter() - t_start
    _log("dist", f"paths dist_* with their kernel checks: {wall:.1f} s of "
                 f"wall time")
    phases["dist"] = {"wall_s": wall, "ranks": D, "ranks_s": ranks_s}
    return {"launches": launches, "assemble": asm, "spd": spd}


BAL_CONFIG = "benchmark/configs/bal_dubrovnik_356.json"    # the cell's
BAL_TRAFFIC = "benchmark/traffic/closed_dubrovnik_it10.json"  # and its start
BAL_SEED = 7                # the start's draws
BAL_LAM = 1e-4              # the damping of the checked reduced system


def bal_paths(dev, run_phase, check_spd, phases):
    """Path BAL: the dubrovnik-solve cell's generated scene and start on
    schur_bal's bucketed layout, float32. ba_assemble's 9-wide kernel over
    every bucket grid against the grids' plain version at
    ASSEMBLE_REL_TOL an output, two launches bitwise, timed against its
    bound; spd_solve at n = 3,204 on the start's reduced camera system
    (check_spd); solve_bal's 10 iterations with every launch count set to
    0 just before (run_phase), under the cell's gate, and again, which
    must give the same bits. Returns {"assemble": {...}, "spd": {...}}."""
    import numpy as np
    import torch

    from benchmark.harness import scenes
    from benchmark.scenes import bal_city
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.ops import ba_assemble, spd_solve
    from slam_tricks_tpu_torch.residuals import bal
    from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
    from slam_tricks_tpu_torch.solvers import schur, schur_bal

    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    cfg = json.loads((ROOT / BAL_CONFIG).read_text())
    traffic = json.loads((ROOT / BAL_TRAFFIC).read_text())
    spec = {k: v for k, v in cfg["scene"].items() if k != "kind"}
    sc = bal_city.make(**spec)
    C, L = sc.n_cams, sc.n_points
    fixed = torch.as_tensor(scenes.fixed_mask(C, cfg["gauge"]), device=dev)
    R, t, X = scenes.perturbed_start(
        torch.as_tensor(sc.R, dtype=f64, device=dev),
        torch.as_tensor(sc.t, dtype=f64, device=dev),
        torch.as_tensor(sc.points, dtype=f64, device=dev), fixed,
        traffic["perturb"], BAL_SEED)
    lv = traffic["perturb_intrinsics"]
    K = torch.as_tensor(bal_city.intrinsics(**spec), dtype=f64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(BAL_SEED + 1)
    dK = torch.randn(K.shape, generator=gen, dtype=f64, device=dev) * (
        torch.tensor([lv["f"], lv["k1"], lv["k2"]], dtype=f64, device=dev)
        * (~fixed)[:, None])
    K = torch.stack([K[:, 0] * (1.0 + dK[:, 0]), K[:, 1] + dK[:, 1],
                     K[:, 2] + dK[:, 2]], dim=1)
    R, t, K, X = (a.to(f32).contiguous() for a in (R, t, K, X))
    obs = BAObservations(
        cam_idx=torch.as_tensor(sc.cam.astype(np.int32), device=dev),
        lm_idx=torch.as_tensor(sc.lm.astype(np.int32), device=dev),
        uv=torch.as_tensor(sc.uv, dtype=f32, device=dev),
        weight=torch.as_tensor(sc.w, dtype=f32, device=dev))
    work = schur_bal.build_bal_work(obs, C, L, dtype=f32)
    grids = work.grids
    n_obs = int((obs.weight > 0).sum())
    _log("path BAL", f"C={C} L={L} observations={n_obs}: "
                     f"{len(grids)} buckets (K {[g.w.shape[0] for g in grids]}"
                     f"), {schur_bal.LIVE_SLOTS} live of "
                     f"{schur_bal.ALLOCATED_SLOTS} slots, "
                     f"{schur_bal.LIVE_PAIRS} within-track pairs; scene and "
                     f"layout {time.perf_counter() - t0:.1f} s")

    # ---- the 9-wide kernel over the bucket grids, against plain ----
    args = (R.reshape(C, 9), t, K, X[work.perm])
    got = ba_assemble.linearize_assemble_grids(*args, grids)
    again = ba_assemble.linearize_assemble_grids(*args, grids)
    ref = ba_assemble.linearize_assemble_grids_plain(*args, grids)
    torch.cuda.synchronize()
    names = ("Hpp", "gp", "Hll", "gl", *(f"W[{i}]" for i in
                                         range(len(grids))), "cost")
    flat = lambda o: (*o[:4], *o[4], o[5])  # noqa: E731
    err = 0.0
    for name, a, b, a2 in zip(names, flat(got), flat(ref), flat(again)):
        rel = _rel(a, b)
        err = max(err, float((a - b).abs().max()))
        if not rel <= ASSEMBLE_REL_TOL:
            raise AssertionError(f"ba_assemble path BAL {name}: rel err "
                                 f"{rel} > {ASSEMBLE_REL_TOL}")
        if not torch.equal(a, a2):
            raise AssertionError(f"ba_assemble path BAL {name}: two "
                                 f"launches differ")
        if name[0] != "W" or name == "W[0]" or name == names[-2]:
            _log("ba_assemble", f"path BAL {name} {tuple(a.shape)} max rel "
                                f"err {rel:.3e}")
    _log("ba_assemble", f"path BAL: every output of {len(grids)} grids "
                        f"within {ASSEMBLE_REL_TOL} of plain, two launches "
                        f"bitwise equal")
    ms, plain_ms, device_ms = _paired_ms(
        lambda: ba_assemble.linearize_assemble_grids(*args, grids),
        lambda: ba_assemble.linearize_assemble_grids_plain(*args, grids))
    bound_ms, bound_by = _bound(
        _nbytes(*args, *(a for g in grids
                         for a in (g.uv0, g.uv1, g.w, g.cam_of_slot)),
                *flat(got)), n_obs * ba_assemble.FLOPS_PER_SLOT9)
    _log("ba_assemble", f"path BAL: kernel {ms:.4f} ms a call "
                        f"({device_ms:.4f} ms on the card alone), plain "
                        f"torch {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                        f"({bound_by})")
    k1 = {"err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "grids": len(grids),
          "K": [g.w.shape[0] for g in grids], "live_slots": n_obs,
          "slots": schur_bal.ALLOCATED_SLOTS}
    del got, again, ref

    # ---- spd_solve at n = 3,204 on the start's reduced camera system ----
    blocks, _ = schur_bal._quantities(bal.BALCameras(R, t, K),
                                      X[work.perm], work)
    system = schur_bal.reduced_camera_system(
        *blocks[:4], blocks[4:], torch.tensor(BAL_LAM, device=dev), fixed,
        work)
    k2 = check_spd(system[0], system[1], "path BAL")
    del blocks, system

    # ---- solve_bal through the CUDA graphs, twice ----
    schur.release_graphs()
    solve = lambda costs=None: schur_bal.solve_bal(  # noqa: E731
        se3.SE3(R, t), K, X, work, fixed_mask=fixed,
        max_iters=traffic["lm_iters"], lambda_init=cfg["lambda_init"],
        costs=costs)
    blocked = spd_solve.BLOCKED_CALLS
    out, cf, launches, ms_it = run_phase("path BAL", solve)
    blocked = spd_solve.BLOCKED_CALLS - blocked
    _check_costs(cf, traffic["gate"]["final_cost"], "path BAL")
    _log("path BAL", f"spd_solve (n = {9 * C}): {blocked} of "
                     f"{launches['spd_solve']} calls on the large-n kernel")
    if (launches["ba_assemble"] < len(grids) * out.it
            or launches["spd_solve"] < 2 * out.it
            or blocked != launches["spd_solve"]):
        raise AssertionError(f"path BAL skipped a kernel: {launches} in "
                             f"{out.it} iterations of {len(grids)} grids, "
                             f"{blocked} on the large-n kernel")
    out2, _, launches2, ms_it2 = run_phase("path BAL again", solve)
    check_same_bits(out, out2, "path BAL")
    phases["BAL"] = {"ms_per_lm_iter": ms_it, "ms_per_lm_iter_again": ms_it2,
                     "iters": out.it, "final_cost": cf[-1],
                     "launches": launches, "blocked_calls": blocked,
                     "launches_again": launches2}
    return {"assemble": k1, "spd": {"path_BAL": k2}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="write torch.profiler tables of paths A, B, L, D, G, "
                         "R and K here")
    args = ap.parse_args()
    t_run0 = time.perf_counter()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    if not (ROOT / "slam_tricks_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no slam_tricks_tpu_torch/ beside "
                         f"{__file__}: run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT))
    import slam_tricks_tpu_torch
    if Path(slam_tricks_tpu_torch.__file__).resolve().parents[1] != ROOT:
        raise SystemExit("chip_smoke: imported slam_tricks_tpu_torch from "
                         f"{slam_tricks_tpu_torch.__file__}, not this checkout")
    from slam_tricks_tpu_torch.ops import (_build, ba_assemble, spd_solve,
                                           tridiag_solve, undistort)
    from slam_tricks_tpu_torch.residuals import camera, robust
    from slam_tricks_tpu_torch.sim import (make_loop_scene, make_scene,
                                           make_trajectory_scene,
                                           perturb_scene)
    from slam_tricks_tpu_torch.evaluation import metrics
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.solvers import (banded_flat, covariance,
                                               incremental, loop_flat,
                                               pcg_flat, schur, schur_flat,
                                               schur_flat_sm, sliding_window)
    from slam_tricks_tpu_torch.solvers.common import set_full_precision

    ops = (ba_assemble, spd_solve, tridiag_solve, undistort)
    if args.profile is not None:
        args.profile.mkdir(parents=True, exist_ok=True)

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    _log("device", f"{kind}; torch {torch.__version__}, CUDA "
                   f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    set_full_precision()
    f32, f64 = torch.float32, torch.float64

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.library()
    _log("build", f"{_build.library_path().name} in "
                  f"{time.perf_counter() - t0:.2f} s "
                  f"(nvcc {' '.join(_build.NVCC_FLAGS)}, one process a source)")

    def check_assemble(args_, index, label, loss=None, timed=True,
                       ref64=False):
        """Kernel 1 against plain on args_ (the kernel with the layout's
        camera index), and two launches against each other bitwise; with
        `timed`, returns (max |k - p|, ms, plain ms, device ms, bound ms,
        bound_by), else (max |k - p|,). With ref64 (inputs where float32's
        own rounding moves an output by more than ASSEMBLE_REL_TOL), kernel
        and plain are each held to plain in float64 on the same inputs:
        the kernel's error at most ASSEMBLE_F64_FACTOR x plain's +
        ASSEMBLE_F64_EPS x the largest value."""
        out_k = ba_assemble.linearize_assemble(*args_, index, loss)
        out_p = ba_assemble.linearize_assemble_plain(*args_, loss)
        out_k2 = ba_assemble.linearize_assemble(*args_, index, loss)
        out_64 = (ba_assemble.linearize_assemble_plain(
            *(a.double() if a.is_floating_point() else a for a in args_),
            loss) if ref64 else out_p)
        torch.cuda.synchronize()
        tol = (ASSEMBLE_REL_TOL if args_[0].dtype == torch.float32
               else ASSEMBLE_REL_TOL_F64)
        if loss is not None:
            label = f"{label} {loss.kind}({loss.param:g})"
        err = 0.0
        for name, a, b, a2, r in zip(("Hpp", "gp", "Hll", "gl", "W", "cost"),
                                     out_k, out_p, out_k2, out_64):
            rel = _rel(a, b)
            err = max(err, float((a - b).abs().max()))
            if ref64:
                ek = float((a.double() - r).abs().max())
                ep = float((b.double() - r).abs().max())
                bound = ASSEMBLE_F64_FACTOR * ep + ASSEMBLE_F64_EPS * float(
                    r.abs().max())
                _log("ba_assemble", f"{label} {name} {tuple(a.shape)} max "
                                    f"rel err {rel:.3e}; against plain in "
                                    f"f64: kernel {ek:.3e}, plain {ep:.3e}")
                if not ek <= bound:
                    raise AssertionError(f"ba_assemble {label} {name}: "
                                         f"kernel {ek} off f64, plain {ep}")
            else:
                _log("ba_assemble", f"{label} {name} {tuple(a.shape)} max "
                                    f"rel err {rel:.3e}")
                if not rel <= tol:
                    raise AssertionError(f"ba_assemble {label} {name}: rel "
                                         f"err {rel} > {tol}")
            if not torch.equal(a, a2):
                raise AssertionError(f"ba_assemble {label} {name}: two "
                                     f"launches differ")
        _log("ba_assemble", f"{label}: two launches bitwise equal in every "
                            f"output; {index.slots.shape[0]} camera-pass "
                            f"segments of {index.slots.shape[1]} slots")
        if not timed:
            return (err,)
        ms, plain_ms, device_ms = _paired_ms(
            lambda: ba_assemble.linearize_assemble(*args_, index, loss),
            lambda: ba_assemble.linearize_assemble_plain(*args_, loss))
        live = int((args_[5] > 0).sum())
        flops = ba_assemble.FLOPS_PER_SLOT + (
            0 if loss is None else ba_assemble.LOSS_FLOPS_PER_SLOT)
        bound_ms, bound_by = _bound(
            _nbytes(*args_, *out_k[:4]) + _nbytes(out_k[4]), live * flops,
            args_[0].dtype == torch.float64)
        _log("ba_assemble", f"{label}: kernel {ms:.4f} ms a call "
                            f"({device_ms:.4f} ms on the card alone); plain "
                            f"torch {plain_ms:.4f} ms, bound {bound_ms:.4f} "
                            f"ms ({bound_by})")
        return err, ms, plain_ms, device_ms, bound_ms, bound_by

    def check_spd(S_, b_, label):
        """Kernel 2 against plain on (S_, b_) (the residual), timed with
        the library's Cholesky beside it: a dict of the kernels line's
        numbers, "blocked" 1 where the call took the large-n kernel."""
        blocked0 = spd_solve.BLOCKED_CALLS
        x_k = spd_solve.spd_solve(S_, b_)
        blocked = spd_solve.BLOCKED_CALLS - blocked0
        x_p = spd_solve.spd_solve_plain(S_, b_)
        S64, b64 = S_.double(), b_.double()
        res_k = float((S64 @ x_k.double() - b64).norm() / b64.norm())
        res_p = float((S64 @ x_p.double() - b64).norm() / b64.norm())
        del S64
        diff = _rel(x_k, x_p)
        eps = SPD_RES_EPS if S_.dtype == torch.float32 else 1e-14
        _log("spd_solve", f"{label} n={S_.shape[0]} {S_.dtype} "
                          f"({'large-n' if blocked else 'small-n'} kernel): "
                          f"|Sx-b|/|b| kernel {res_k:.3e} plain {res_p:.3e}; "
                          f"max|x-x_plain|/max|x_plain| {diff:.3e}")
        if not res_k <= SPD_RES_FACTOR * res_p + eps:
            raise AssertionError(f"spd_solve {label}: residual {res_k} > "
                                 f"{SPD_RES_FACTOR} x plain {res_p} + {eps}")
        ms, plain_ms, device_ms = _paired_ms(
            lambda: spd_solve.spd_solve(S_, b_),
            lambda: spd_solve.spd_solve_plain(S_, b_), reps=3)
        lib_ms = _time_ms(lambda: torch.cholesky_solve(
            b_[:, None], torch.linalg.cholesky_ex(S_)[0]), reps=3)
        n_ = S_.shape[0]
        bound_ms, by = _bound(_nbytes(S_, b_, b_), n_ ** 3 / 3 + 2 * n_ ** 2,
                              S_.dtype == torch.float64)
        _log("spd_solve", f"{label}: kernel {ms:.4f} ms a call "
                          f"({device_ms:.4f} ms on the card alone); plain "
                          f"torch {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                          f"bound {bound_ms:.4f} ms ({by})")
        return {"n": n_, "blocked": blocked,
                "max_abs_err": float((x_k - x_p).abs().max()),
                "residual": res_k, "plain_residual": res_p, "ms": ms,
                "plain_ms": plain_ms, "device_ms": device_ms,
                "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": by}

    # ---- 3. kernel 1: linearize + assemble at the headline shapes ----
    scene = make_scene(n_per_wall=400, n_cams=96, seed=0, dtype=f32, device=dev)
    poses0, points0, fixed = perturb_scene(scene, seed=1)
    work = schur_flat_sm.build_slot_work(scene.obs, scene.n_cams,
                                         scene.n_points, dtype=f32)
    C, L, K = scene.n_cams, scene.n_points, work.w.shape[0]
    n_obs = int((scene.obs.weight > 0).sum())
    _log("scene A", f"C={C} L={L} K={K} live observations={n_obs}")
    args_a = (poses0.R.reshape(C, 9), poses0.t, points0, work.uv0, work.uv1,
              work.w, work.cam_of_slot)
    k1_keys = ("err", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by")
    k1 = dict(zip(k1_keys, check_assemble(args_a, work.cam_index, "path A")))

    def losses(args_):
        """The four robust losses. The chi-square gate is a step in the
        weight, so a slot whose squared residual s lies within rounding of
        its threshold adds itself in one version and not in the other (in
        f32, the kernel's fused multiply-adds move s by ~1e-5 relative):
        the threshold goes in the lowest gap wider than 1e-3 relative
        between two live slots' s in the upper 1%."""
        (r0, r1), *_ = ba_assemble._linearize_sm(*args_)
        live = args_[5] > 0
        s_ = torch.sort(((r0 * r0 + r1 * r1)[live]
                         / args_[5][live]).double()).values
        top = s_[int(0.99 * s_.numel()):]
        wide = torch.nonzero(top[1:] / top[:-1] > 1.001)
        if not wide.numel():
            raise AssertionError("no gap wider than 1e-3 for the gate")
        i = int(wide[0])
        thr = float(torch.sqrt(top[i] * top[i + 1]))
        _log("ba_assemble", f"gate threshold {thr:.6e}: s of the live slots "
                            f"next to it {float(top[i]):.6e} and "
                            f"{float(top[i + 1]):.6e}; gates "
                            f"{int((s_ > thr).sum())} of {s_.numel()}")
        return (robust.huber(1.0), robust.cauchy(1.0), robust.tukey(4.685),
                robust.chi2_gate(thr))

    # ---- 3b. kernel 1 with each robust loss, at path A's shapes ----
    loss_err = 0.0
    for loss in losses(args_a):
        loss_err = max(loss_err, check_assemble(args_a, work.cam_index,
                                                "path A", loss, False)[0])

    # ---- 4. kernel 2: SPD solve of the first step's S (n = 6C) ----
    out_p = ba_assemble.linearize_assemble_plain(*args_a)
    lam = torch.tensor(1e-4, dtype=f32, device=dev)
    S, b, *_ = schur_flat_sm.reduced_camera_system(*out_p[:5], lam, fixed, work)
    rng = torch.Generator(device="cpu").manual_seed(0)
    A = torch.randn(6 * C, 6 * C, generator=rng, dtype=f64)
    S_rand = (A @ A.T + 6 * C * torch.eye(6 * C, dtype=f64)).to(dev, f32)
    b_rand = torch.randn(6 * C, generator=rng).to(dev, f32)
    k2_abs = 0.0
    for label, S_, b_ in (("BA S", S, b), ("random SPD", S_rand, b_rand)):
        x_k = spd_solve.spd_solve(S_, b_)
        x_p = spd_solve.spd_solve_plain(S_, b_)
        S64, b64 = S_.double(), b_.double()
        res_k = float((S64 @ x_k.double() - b64).norm() / b64.norm())
        res_p = float((S64 @ x_p.double() - b64).norm() / b64.norm())
        diff = float((x_k - x_p).norm() / x_p.norm())
        cond = float(torch.linalg.cond(S64))
        k2_abs = max(k2_abs, float((x_k - x_p).abs().max()))
        _log("spd_solve", f"{label} n={S_.shape[0]} cond={cond:.3e}: "
                          f"|Sx-b|/|b| kernel {res_k:.3e} plain {res_p:.3e}; "
                          f"|x-x_plain|/|x_plain| {diff:.3e}")
        if not res_k <= SPD_RES_FACTOR * res_p + 1e-6:
            raise AssertionError(f"spd_solve {label}: residual {res_k} > "
                                 f"{SPD_RES_FACTOR} x plain {res_p} + 1e-6")
        if label == "random SPD" and not diff <= SPD_RANDOM_REL_TOL:
            raise AssertionError(f"spd_solve {label}: |x - x_plain| rel {diff}")
    k2_ms, k2_plain_ms, k2_device_ms = _paired_ms(
        lambda: spd_solve.spd_solve(S, b),
        lambda: spd_solve.spd_solve_plain(S, b))
    k2_lib_ms = _time_ms(lambda: torch.cholesky_solve(
        b[:, None], torch.linalg.cholesky_ex(S)[0]))
    n = S.shape[0]
    k2_bound, k2_by = _bound(_nbytes(S, b, b), n ** 3 / 3 + 2 * n ** 2)
    _log("spd_solve", f"kernel {k2_ms:.4f} ms a call ({k2_device_ms:.4f} "
                      f"ms on the card alone); plain torch (cholesky_ex + "
                      f"cholesky_solve) {k2_plain_ms:.4f} ms, library "
                      f"{k2_lib_ms:.4f} ms, bound {k2_bound:.5f} ms ({k2_by})")

    # ---- 4b. kernel 2 on a matrix that is not positive definite ----
    n = S.shape[0]
    for label, i in (("a negative pivot in the first tile", 7),
                     ("a negative last pivot", n - 1)):
        S_bad = S.clone()
        S_bad[i, i] = -S_bad[i, i].abs()
        x_k = spd_solve.spd_solve(S_bad, b)
        x_p = spd_solve.spd_solve_plain(S_bad, b)
        torch.cuda.synchronize()
        nan_k, nan_p = torch.isnan(x_k), torch.isnan(x_p)
        _log("spd_solve", f"not positive definite, {label} (row {i}): NaN in "
                          f"{int(nan_k.sum())} of {n} kernel values, "
                          f"{int(nan_p.sum())} plain")
        if not (nan_p.all() and torch.equal(nan_k, nan_p)):
            raise AssertionError(f"spd_solve {label}: the kernel's NaN "
                                 f"{int(nan_k.sum())} != plain's "
                                 f"{int(nan_p.sum())} of {n}")

    # ---- 5. reference: a small f64 scene through the kernels vs the CPU ----
    small = dict(n_per_wall=60, n_cams=16, seed=3, dtype=f64)
    results = []
    for device in ("cpu", dev):
        sc = make_scene(device=device, **small)
        p0, x0, fx = perturb_scene(sc, seed=4)
        wk = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                           dtype=f64)
        results.append(schur_flat_sm.solve_ba_flat_sm(p0, x0, wk, fixed_mask=fx,
                                                      max_iters=15))
    ref, got = results
    perr = float((got.poses.t.cpu() - ref.poses.t).abs().max())
    _log("reference A", f"16 cameras f64: card {got.it} iterations cost "
                        f"{float(got.cost):.3e}, CPU {ref.it} iterations cost "
                        f"{float(ref.cost):.3e}; max pose diff {perr:.3e}")
    if got.it != ref.it or not perr <= SMALL_POSE_TOL:
        raise AssertionError("card and CPU solves of the small scene differ")

    # ---- 6. path A: headline solve through the kernels ----
    solve_a = lambda iters, costs=None: schur_flat_sm.solve_ba_flat_sm(  # noqa: E731
        poses0, points0, work, fixed_mask=fixed, max_iters=iters, costs=costs)
    solve_a(2)      # warm-up
    torch.cuda.synchronize()
    _reset_counts(*ops)
    blocked_a = spd_solve.BLOCKED_CALLS
    costs = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    final = solve_a(20, costs)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    launches_a = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in ops}
    ms_per_iter_a = start.elapsed_time(end) / max(final.it, 1)
    c = [float(v) for v in costs]
    _log("path A", f"{final.it} LM iterations, cost {c[0]:.6e} -> {c[-1]:.6e};"
                   f" launches {launches_a}; {ms_per_iter_a:.4f} ms per LM "
                   f"iteration (CUDA events; host wall {wall_s:.3f} s)")
    _log("path A", "costs " + " ".join(f"{v:.4e}" for v in c))
    basin = ("global (~1e-10)" if c[-1] < 1e-6 else "local (~2.5e-2)")
    _log("path A", f"basin reached: {basin}")
    if launches_a["ba_assemble"] < 21 or launches_a["spd_solve"] < 20:
        raise AssertionError(f"path A skipped a kernel: {launches_a}")
    blocked_a = spd_solve.BLOCKED_CALLS - blocked_a
    _log("path A", f"spd_solve (n = {6 * C}): {blocked_a} of "
                   f"{launches_a['spd_solve']} calls on the large-n kernel")
    if blocked_a:
        raise AssertionError(f"path A: {blocked_a} spd_solve calls at n = "
                             f"{6 * C} took the large-n kernel")
    _check_costs(c, FINAL_COST_MAX, "path A")
    if (final.poses.R.shape != (C, 3, 3) or final.points.shape != (L, 3)
            or not torch.isfinite(final.points).all()
            or not torch.isfinite(final.poses.R).all()):
        raise AssertionError("path A returned malformed or non-finite state")
    check_same_bits(final, solve_a(20), "path A")
    if args.profile is not None:
        _profile(lambda: solve_a(5), args.profile / "path_a.txt",
                 "path A, 5 LM iterations")
    final_a_cost = c[-1]
    costs_a = c

    # ---- 6b. path O: schur.solve_ba, dense and PCG, on path A's scene ----
    def run_phase(label, fn, iters_of=lambda out: out.it):
        """fn(costs) with every launch count set to 0 just before it: (its
        result, float costs, launches, ms per LM iteration by CUDA events
        around the whole call, host loop included)."""
        torch.cuda.synchronize()
        _reset_counts(*ops)
        costs = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn(costs)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in ops}
        ms = start.elapsed_time(end) / max(iters_of(out), 1)
        cf = [float(v) for v in costs]
        if cf:
            _log(label, f"{iters_of(out)} LM iterations, cost {cf[0]:.6e} -> "
                        f"{cf[-1]:.6e}; launches {launches}; {ms:.4f} ms per "
                        f"LM iteration (CUDA events; host wall {wall_s:.3f} "
                        f"s)")
        return out, cf, launches, ms

    def check_state(out, C_, L_, label):
        if (out.poses.R.shape != (C_, 3, 3) or out.points.shape != (L_, 3)
                or not torch.isfinite(out.points).all()
                or not torch.isfinite(out.poses.R).all()):
            raise AssertionError(f"{label} returned malformed or non-finite "
                                 f"state")

    phases = {}
    for solver in ("dense", "pcg"):
        label = f"path O {solver}"
        out, cf, launches, ms = run_phase(label, lambda costs: schur.solve_ba(
            poses0, points0, scene.obs, fixed_mask=fixed, max_iters=20,
            linear_solver=solver, costs=costs))
        want = out.it if solver == "dense" else 0
        if launches["spd_solve"] != want:
            raise AssertionError(f"{label}: {launches['spd_solve']} spd_solve "
                                 f"launches, want {want}")
        _check_costs(cf, FINAL_COST_MAX, label)
        check_state(out, C, L, label)
        phases[f"O_{solver}"] = {"ms_per_lm_iter": ms, "iters": out.it,
                                 "final_cost": cf[-1], "launches": launches}

    # ---- 6c. path F: schur_flat.solve_ba_flat (dense) on path A's scene ----
    work_f = schur_flat.build_flat_work(scene.obs, C, L, dtype=f32)
    final_f, cf, launches_f, ms = run_phase(
        "path F", lambda costs: schur_flat.solve_ba_flat(
            poses0, points0, scene.obs, work_f, fixed_mask=fixed,
            max_iters=20, costs=costs))
    if (launches_f["ba_assemble"] != final_f.it + 1
            or launches_f["spd_solve"] != final_f.it):
        raise AssertionError(f"path F skipped a kernel: {launches_f}")
    _check_costs(cf, FINAL_COST_MAX, "path F")
    check_state(final_f, C, L, "path F")
    # the same math as path A: the first accepted step's cost agrees
    first_f = next(v for v in cf[1:] if v < cf[0])
    first_a = next(v for v in costs_a[1:] if v < costs_a[0])
    rel_fa = abs(first_f - first_a) / first_a
    _log("path F", f"first accepted step's cost {first_f:.8e}, path A's "
                   f"{first_a:.8e}: rel {rel_fa:.3e} (bound {FA_REL_TOL})")
    if not rel_fa <= FA_REL_TOL:
        raise AssertionError(f"path F: first step rel {rel_fa} vs path A")
    phases["F"] = {"ms_per_lm_iter": ms, "iters": final_f.it,
                   "final_cost": cf[-1], "launches": launches_f,
                   "first_step_rel_to_a": rel_fa}

    # ---- 6d. path V: covariances at path F's converged state ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose_cov, point_cov = covariance.ba_covariances(
        final_f.poses, final_f.points, scene.obs, fixed,
        compute_landmarks=True)
    torch.cuda.synchronize()
    cov_s = time.perf_counter() - t0
    check_covariances(pose_cov, point_cov, fixed, scene.obs, "path V (F)")
    phases["V_F"] = {"seconds": cov_s}
    del pose_cov, point_cov, work_f

    # ---- 7. path B scene: the large-C trajectory problem ----
    t0 = time.perf_counter()
    tscene = make_trajectory_scene(n_cams=1024, n_points=200_000, track_len=8,
                                   seed=11, dtype=f32, device=dev)
    tposes0, tpoints0, tfixed = perturb_scene(
        tscene, pose_rot_noise=0.002, pose_trans_noise=0.01, point_noise=0.01,
        seed=12)
    bw = banded_flat.build_banded_work(tscene.obs, tscene.n_cams,
                                       tscene.n_points, dtype=f32)
    torch.cuda.synchronize()
    setup_b_s = time.perf_counter() - t0
    CB, LB_, KB = bw.n_cams, bw.n_points, bw.w.shape[0]
    LpadB = bw.w.shape[1]
    n_obs_b = int((bw.w > 0).sum())
    _log("scene B", f"C={CB} L={LB_} K={KB} Lpad={LpadB} live observations="
                    f"{n_obs_b}; set-up (scene, perturbation, layout) "
                    f"{setup_b_s:.2f} s")

    # ---- 8. kernel 1 at path B's shapes ----
    tpoints_s = tpoints0[bw.gather_idx]
    args_b = (tposes0.R.reshape(CB, 9), tposes0.t, tpoints_s, bw.uv0, bw.uv1,
              bw.w, bw.cam_of_slot)
    k1b = dict(zip(k1_keys, check_assemble(args_b, bw.cam_index, "path B")))
    for loss in losses(args_b):
        got = check_assemble(args_b, bw.cam_index, "path B", loss,
                             loss.kind == "tukey")
        loss_err = max(loss_err, got[0])
        if loss.kind == "tukey":
            k1_loss = dict(zip(k1_keys, got))

    # ---- 9. kernel 3: block-tridiagonal solve ----
    Gt, mt = 128, 48        # the system of bench.py:stage_tridiag_ab
    rng_np = np.random.default_rng(0)
    Gm = rng_np.normal(size=(Gt, mt, mt + 8))
    Dt = torch.as_tensor(Gm @ Gm.transpose(0, 2, 1) + 8 * np.eye(mt)[None],
                         dtype=f32, device=dev)
    Et = torch.as_tensor(0.3 * rng_np.normal(size=(Gt - 1, mt, mt)),
                         dtype=f32, device=dev)
    rt = torch.as_tensor(rng_np.normal(size=(Gt, mt)), dtype=f32, device=dev)
    blocks_b = ba_assemble.linearize_assemble_plain(*args_b)[:5]
    Dm, Em, rm, *_ = banded_flat.reduced_camera_system(*blocks_b, lam, tfixed,
                                                       bw)
    del blocks_b

    def dense(D, E):
        return _dense_tridiag(D.double(), E.double())

    k3_abs = 0.0
    for label, D_, E_, r_ in (("stage_tridiag_ab", Dt, Et, rt),
                              ("path B first step", Dm, Em, rm)):
        x_k = tridiag_solve.tridiag_solve(D_, E_, r_)
        x_p = tridiag_solve.tridiag_solve_plain(D_, E_, r_)
        torch.cuda.synchronize()
        T64, r64 = dense(D_, E_), r_.double().reshape(-1)
        res_k = float((T64 @ x_k.double().reshape(-1) - r64).norm() / r64.norm())
        res_p = float((T64 @ x_p.double().reshape(-1) - r64).norm() / r64.norm())
        diff = _rel(x_k, x_p)
        k3_abs = max(k3_abs, float((x_k - x_p).abs().max()))
        _log("tridiag_solve", f"{label} (G, m)={tuple(D_.shape[:2])}: "
                              f"|Tx-r|/|r| kernel {res_k:.3e} plain {res_p:.3e};"
                              f" max|x-x_plain|/max|x_plain| {diff:.3e}")
        if not res_k <= TRI_RES_FACTOR * res_p + 1e-6:
            raise AssertionError(f"tridiag_solve {label}: residual {res_k} > "
                                 f"{TRI_RES_FACTOR} x plain {res_p} + 1e-6")
        if label == "stage_tridiag_ab" and not diff <= TRI_RANDOM_REL_TOL:
            raise AssertionError(f"tridiag_solve {label}: rel diff {diff}")
    Tdense = dense(Dm, Em).float()
    rdense = rm.reshape(-1, 1)
    k3_ms, k3_plain_ms, k3_device_ms = _paired_ms(
        lambda: tridiag_solve.tridiag_solve(Dm, Em, rm),
        lambda: tridiag_solve.tridiag_solve_plain(Dm, Em, rm), reps=3)
    k3_lib_ms = _time_ms(lambda: torch.cholesky_solve(
        rdense, torch.linalg.cholesky_ex(Tdense)[0]), reps=3)
    del Tdense
    Gb, mb = Dm.shape[0], Dm.shape[1]
    k3_bound, k3_by = _bound(_nbytes(Dm, Em, rm, rm),
                             tridiag_solve.flops(Gb, mb))
    _log("tridiag_solve", f"path B shape (G, m)=({Gb}, {mb}): kernel "
                          f"{k3_ms:.4f} ms a call ({k3_device_ms:.4f} ms on "
                          f"the card alone); plain torch {k3_plain_ms:.4f} ms, "
                          f"library (cholesky_ex + cholesky_solve of the dense "
                          f"{Gb * mb}^2 matrix) {k3_lib_ms:.4f} ms, bound "
                          f"{k3_bound:.5f} ms ({k3_by})")

    # the widest band, K = 32: (G, m) = (16, 192) f32, the instance whose
    # working tiles sit in a global scratch
    Gw, mw = 16, 192
    Gm = rng_np.normal(size=(Gw, mw, mw + 8))
    Dw = torch.as_tensor(Gm @ Gm.transpose(0, 2, 1) + 8 * np.eye(mw)[None],
                         dtype=f32, device=dev)
    Ew = torch.as_tensor(0.3 * rng_np.normal(size=(Gw - 1, mw, mw)),
                         dtype=f32, device=dev)
    rw = torch.as_tensor(rng_np.normal(size=(Gw, mw)), dtype=f32, device=dev)
    assert tridiag_solve.smem_bytes(mw, f32) > _build.SMEM_PER_BLOCK
    x_k = tridiag_solve.tridiag_solve(Dw, Ew, rw)
    x_p = tridiag_solve.tridiag_solve_plain(Dw, Ew, rw)
    T64, r64 = dense(Dw, Ew), rw.double().reshape(-1)
    res_k = float((T64 @ x_k.double().reshape(-1) - r64).norm() / r64.norm())
    res_p = float((T64 @ x_p.double().reshape(-1) - r64).norm() / r64.norm())
    k3_abs = max(k3_abs, float((x_k - x_p).abs().max()))
    if not res_k <= TRI_RES_FACTOR * res_p + 1e-6:
        raise AssertionError(f"tridiag_solve (16, 192): residual {res_k} > "
                             f"{TRI_RES_FACTOR} x plain {res_p} + 1e-6")
    Tdense = T64.float()
    rdense = rw.reshape(-1, 1)
    kw_ms, kw_plain_ms, kw_device_ms = _paired_ms(
        lambda: tridiag_solve.tridiag_solve(Dw, Ew, rw),
        lambda: tridiag_solve.tridiag_solve_plain(Dw, Ew, rw), reps=3)
    kw_lib_ms = _time_ms(lambda: torch.cholesky_solve(
        rdense, torch.linalg.cholesky_ex(Tdense)[0]), reps=3)
    del Tdense, T64
    kw_bound, kw_by = _bound(_nbytes(Dw, Ew, rw, rw),
                             tridiag_solve.flops(Gw, mw))
    _log("tridiag_solve", f"K = 32 shape (G, m)=({Gw}, {mw}), tiles in global "
                          f"memory: |Tx-r|/|r| kernel {res_k:.3e} plain "
                          f"{res_p:.3e}; kernel {kw_ms:.4f} ms a call "
                          f"({kw_device_ms:.4f} ms on the card alone); plain "
                          f"torch {kw_plain_ms:.4f} ms, library (dense "
                          f"{Gw * mw}^2) "
                          f"{kw_lib_ms:.4f} ms, bound {kw_bound:.5f} ms "
                          f"({kw_by})")

    # the single right-hand side as a 3-D r (q = 1) runs the same kernel
    # instance: the same bits as the 2-D answer, at path B's shape, in f32
    # and f64
    for dtype_b in (f32, f64):
        Db, Eb, rb = (a.to(dtype_b).contiguous() for a in (Dm, Em, rm))
        x2 = tridiag_solve.tridiag_solve(Db, Eb, rb)
        x3 = tridiag_solve.tridiag_solve(Db, Eb, rb[:, :, None].contiguous())
        torch.cuda.synchronize()
        _log("tridiag_solve", f"path B (G, m, q)=({Gb}, {mb}, 1) {dtype_b} as "
                              f"a 3-D r: bitwise equal to the 2-D answer: "
                              f"{torch.equal(x3[..., 0], x2)}")
        if x3.shape != (Gb, mb, 1) or not torch.equal(x3[..., 0], x2):
            raise AssertionError(f"tridiag_solve: r (G, m, 1) {dtype_b} does "
                                 f"not give r (G, m)'s bits")
    del Db, Eb, rb, x2, x3

    # ---- 10. reference: a small f64 trajectory solve, card vs CPU ----
    results = []
    for device in ("cpu", dev):
        sc = make_trajectory_scene(n_cams=32, n_points=600, track_len=6,
                                   seed=71, pix_noise=1e-3, dtype=f64,
                                   device=device)
        p0, x0, fx = perturb_scene(sc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=72)
        wk = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                           dtype=f64)
        results.append(banded_flat.solve_ba_banded(p0, x0, wk, fixed_mask=fx,
                                                   max_iters=6))
    ref, got = results
    perr = float((got.poses.t.cpu() - ref.poses.t).abs().max())
    _log("reference B", f"32 cameras f64: card {got.it} iterations cost "
                        f"{float(got.cost):.6e}, CPU {ref.it} iterations cost "
                        f"{float(ref.cost):.6e}; max pose diff {perr:.3e}")
    if got.it != ref.it or not perr <= SMALL_POSE_TOL:
        raise AssertionError("card and CPU trajectory solves differ")

    # ---- 11. path B: the large-C trajectory solve through the kernels ----
    solve_b = lambda iters, costs=None: banded_flat.solve_ba_banded(  # noqa: E731
        tposes0, tpoints0, bw, fixed_mask=tfixed, max_iters=iters, costs=costs)
    solve_b(2)      # warm-up
    torch.cuda.synchronize()
    _reset_counts(*ops)
    costs = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    final = solve_b(12, costs)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    launches_b = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in ops}
    ms_per_iter_b = start.elapsed_time(end) / max(final.it, 1)
    c = [float(v) for v in costs]
    _log("path B", f"{final.it} LM iterations, cost {c[0]:.6e} -> {c[-1]:.6e};"
                   f" launches {launches_b}; {ms_per_iter_b:.4f} ms per LM "
                   f"iteration (CUDA events; host wall {wall_s:.3f} s)")
    _log("path B", "costs " + " ".join(f"{v:.4e}" for v in c))
    if (launches_b["tridiag_solve"] < max(final.it, 12)
            or launches_b["ba_assemble"] < max(final.it + 1, 13)):
        raise AssertionError(f"path B skipped a kernel: {launches_b}")
    _check_costs(c, B_FINAL_COST_MAX, "path B")
    if (final.poses.R.shape != (CB, 3, 3) or final.points.shape != (LB_, 3)
            or not torch.isfinite(final.points).all()
            or not torch.isfinite(final.poses.R).all()):
        raise AssertionError("path B returned malformed or non-finite state")
    check_same_bits(final, solve_b(12), "path B")
    if args.profile is not None:
        _profile(lambda: solve_b(3), args.profile / "path_b.txt",
                 "path B, 3 LM iterations")
    final_b_cost = c[-1]
    final_b_poses = final.poses
    costs_b = c
    del args_b, tpoints_s

    # ---- 11b. reference: small f64 loop and stream solves, card vs CPU ----
    results = []
    for device in ("cpu", dev):
        sc = make_loop_scene(n_cams=16, n_points=200, track_len=3, seed=31,
                             pix_noise=1e-3, dtype=f64, device=device)
        p0, x0, fx = perturb_scene(sc, pose_rot_noise=0.002,
                                   pose_trans_noise=0.01, point_noise=0.01,
                                   seed=32)
        lw_ = loop_flat.build_loop_work(sc.obs, sc.n_cams, sc.n_points,
                                        dtype=f64, max_band=3)
        results.append(loop_flat.solve_ba_loop(p0, x0, lw_, fixed_mask=fx,
                                               max_iters=6))
    ref, got = results
    perr = float((got.poses.t.cpu() - ref.poses.t).abs().max())
    _log("reference L", f"16 cameras f64, loop closures: card {got.it} "
                        f"iterations cost {float(got.cost):.6e}, CPU {ref.it} "
                        f"iterations cost {float(ref.cost):.6e}; max pose "
                        f"diff {perr:.3e}")
    if got.it != ref.it or not perr <= SMALL_POSE_TOL:
        raise AssertionError("card and CPU loop-closure solves differ")
    results = []
    for device in ("cpu", dev):
        sc = make_trajectory_scene(n_cams=32, n_points=480, track_len=4,
                                   seed=11, pix_noise=1e-3, dtype=f64,
                                   device=device)
        p0, x0, _ = perturb_scene(sc, pose_rot_noise=0.002,
                                  pose_trans_noise=0.01, point_noise=0.01,
                                  seed=12)
        wk = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                           dtype=f64)
        fx = torch.zeros(32, dtype=torch.bool, device=device)
        fx[[0, 15]] = True
        st, cd = incremental.smoother_init(p0, x0, wk, n_active=16,
                                           fixed_mask=fx)
        for a_prev in (16, 20, 24, 28):
            st, cd = incremental.smoother_arrive(
                st, wk, a_prev=a_prev, a_new=a_prev + 4, c_dirty=cd,
                fixed_mask=fx, gn_steps=2)
        results.append(st)
    ref, got = results
    perr = float((got.poses.t.cpu() - ref.poses.t).abs().max())
    _log("reference I", f"32 cameras f64, stream 16..32 by 4: card cost "
                        f"{float(got.cost):.6e}, CPU cost "
                        f"{float(ref.cost):.6e}; max pose diff {perr:.3e}")
    if not perr <= SMALL_POSE_TOL:
        raise AssertionError("card and CPU streams differ")

    # ---- 11c. path L: the loop-closure solve through the kernels ----
    t0 = time.perf_counter()
    lscene = make_loop_scene(n_cams=1024, n_points=200_000, track_len=8,
                             seed=21, dtype=f32, device=dev)
    lposes0, lpoints0, lfixed = perturb_scene(
        lscene, pose_rot_noise=0.002, pose_trans_noise=0.01, point_noise=0.01,
        seed=22)
    lw = loop_flat.build_loop_work(lscene.obs, lscene.n_cams, lscene.n_points,
                                   dtype=f32, max_band=8)
    torch.cuda.synchronize()
    setup_l_s = time.perf_counter() - t0
    n_lc = int((lw.lc_w.sum(0) > 0).sum())
    support = int(lw.onehot_A.sum())
    width = min(3 * lw.lc_w.shape[1], 6 * lw.onehot_A.shape[0])
    _log("scene L", f"C={lscene.n_cams} L={lscene.n_points} live "
                    f"observations={int((lscene.obs.weight > 0).sum())}; "
                    f"{n_lc} loop-closure landmarks, {support} support "
                    f"cameras, Woodbury width {width}; set-up {setup_l_s:.2f} s")
    if (n_lc, support, width) != LOOP_STRUCTURE:
        raise AssertionError(f"path L structure {(n_lc, support, width)} != "
                             f"{LOOP_STRUCTURE}")
    lbw = lw.banded
    args_l = (lposes0.R.reshape(lbw.n_cams, 9), lposes0.t,
              lpoints0[lbw.gather_idx], lbw.uv0, lbw.uv1, lbw.w,
              lbw.cam_of_slot)
    k1l = dict(zip(k1_keys, check_assemble(args_l, lbw.cam_index,
                                           "path L single-run grid")))
    del args_l
    solve_l = lambda iters, costs=None: loop_flat.solve_ba_loop(  # noqa: E731
        lposes0, lpoints0, lw, fixed_mask=lfixed, max_iters=iters, costs=costs)
    solve_l(2)      # warm-up
    torch.cuda.synchronize()
    _reset_counts(*ops)
    costs = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    final = solve_l(12, costs)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    launches_l = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in ops}
    ms_per_iter_l = start.elapsed_time(end) / max(final.it, 1)
    c = [float(v) for v in costs]
    _log("path L", f"{final.it} LM iterations, cost {c[0]:.6e} -> {c[-1]:.6e};"
                   f" launches {launches_l}; {ms_per_iter_l:.4f} ms per LM "
                   f"iteration (CUDA events; host wall {wall_s:.3f} s)")
    _log("path L", "costs " + " ".join(f"{v:.4e}" for v in c))
    if launches_l["ba_assemble"] != final.it + 1:
        raise AssertionError(f"path L: {launches_l['ba_assemble']} ba_assemble"
                             f" launches for {final.it} iterations")
    _check_costs(c, B_FINAL_COST_MAX, "path L")
    if (final.poses.R.shape != (lscene.n_cams, 3, 3)
            or final.points.shape != (lscene.n_points, 3)
            or not torch.isfinite(final.points).all()
            or not torch.isfinite(final.poses.R).all()):
        raise AssertionError("path L returned malformed or non-finite state")
    if args.profile is not None:
        _profile(lambda: solve_l(3), args.profile / "path_l.txt",
                 "path L, 3 LM iterations")
    final_l_cost = c[-1]
    costs_l = c

    # the plain torch stored-factor loop at path L's system (G = 128)
    (Hpp_l, _, Hll_l, _, W_l), _ = banded_flat._banded_quantities(
        lposes0, lpoints0[lbw.gather_idx], lbw)
    bands_l, *_ = banded_flat._assemble_bands(Hpp_l, Hll_l, W_l, lam, lfixed,
                                              lbw)
    Dl, El, _ = banded_flat._group_superblocks(bands_l, lbw.n_cams)
    del Hpp_l, Hll_l, W_l, bands_l
    fac_l = banded_flat.block_tridiag_factor(Dl, El)
    Rl = torch.randn(Dl.shape[0], Dl.shape[1], 1 + width, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    stored_ms = {
        "G": Dl.shape[0], "m": Dl.shape[1], "q": 1 + width,
        "factor_ms": _time_ms(lambda: banded_flat.block_tridiag_factor(Dl, El),
                              reps=3),
        "forward_ms": _time_ms(lambda: banded_flat.tridiag_forward(fac_l, Rl),
                               reps=3),
        "backward_ms": _time_ms(
            lambda: banded_flat.tridiag_backward(fac_l, Rl), reps=3)}
    _log("path L", f"plain torch stored factor at (G, m) = "
                   f"({stored_ms['G']}, {stored_ms['m']}): factor "
                   f"{stored_ms['factor_ms']:.3f} ms, forward and backward of "
                   f"{1 + width} columns {stored_ms['forward_ms']:.3f} and "
                   f"{stored_ms['backward_ms']:.3f} ms")
    lobs = lscene.obs
    del lscene, lw, lbw, fac_l, Rl, Dl, El

    # ---- 11d. path I: the incremental smoother on path B's scene ----
    n_start, n_step, gn_steps = 512, 64, 2
    _reset_counts(*ops)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, c_dirty = incremental.smoother_init(
        tposes0, tpoints0, bw, fixed_mask=tfixed, n_active=n_start)
    end.record()
    end.synchronize()
    init_ms = start.elapsed_time(end)
    init_iters = tridiag_solve.LAUNCHES
    stream_costs = [float(state.cost)]
    arrival_ms = []
    for a_prev in range(n_start, CB, n_step):
        start.record()
        state, c_dirty = incremental.smoother_arrive(
            state, bw, a_prev=a_prev, a_new=a_prev + n_step, c_dirty=c_dirty,
            fixed_mask=tfixed, gn_steps=gn_steps)
        end.record()
        end.synchronize()
        arrival_ms.append(start.elapsed_time(end))
        stream_costs.append(float(state.cost))
    launches_i = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in ops}
    n_arrivals = len(arrival_ms)
    ms_per_arrival_i = statistics.median(arrival_ms)
    _log("path I", f"start on {n_start} cameras ({init_iters} LM iterations, "
                   f"{init_ms:.2f} ms), {n_arrivals} arrivals of {n_step} "
                   f"to {CB}, {gn_steps} Gauss-Newton steps each: launches "
                   f"{launches_i}; ms per arrival (CUDA events) "
                   + " ".join(f"{v:.2f}" for v in arrival_ms))
    _log("path I", "costs " + " ".join(f"{v:.4e}" for v in stream_costs))
    # the start solve's iterations (one tridiag_solve each, one ba_assemble
    # each and one at its start), the stored factor's linearization, and a
    # step and four backtracking costs a Gauss-Newton step
    want = init_iters + 2 + n_arrivals * gn_steps * 5
    if (n_arrivals != 8 or not 1 <= init_iters <= 20
            or launches_i["ba_assemble"] != want):
        raise AssertionError(f"path I: launches {launches_i}, want "
                             f"ba_assemble {want}")
    if not all(v == v and abs(v) != float("inf") for v in stream_costs):
        raise AssertionError(f"path I: non-finite cost: {stream_costs}")
    rms_i = math.sqrt(2.0 * stream_costs[-1] / n_obs_b)
    _log("path I", f"final cost {stream_costs[-1]:.6e} over {n_obs_b} "
                   f"observations: RMS reprojection error {rms_i:.3e} "
                   f"(bound {I_RMS_MAX})")
    if not rms_i < I_RMS_MAX:
        raise AssertionError(f"path I: RMS error {rms_i} >= {I_RMS_MAX}")
    if (not torch.isfinite(state.poses.t).all()
            or not torch.isfinite(state.points_s).all()):
        raise AssertionError("path I returned non-finite state")
    final_i_cost = stream_costs[-1]
    del state

    # ---- 11e. path D: schur.solve_ba "paired", the exact dense comparator,
    # on path B's scene (bench.py:1457-1484) ----
    t0 = time.perf_counter()
    tobs = tscene.obs
    pairs = schur.build_track_pairs(tobs.cam_idx, tobs.lm_idx, dtype=f32)
    torch.cuda.synchronize()
    n_pairs = int((pairs.pair_w > 0).sum())
    _log("path D", f"{n_pairs} within-track pairs in {pairs.pair_a.shape[0]} "
                   f"chunks of {pairs.pair_a.shape[1]}; built in "
                   f"{time.perf_counter() - t0:.2f} s")
    solve_d = lambda iters, costs=None: schur.solve_ba(  # noqa: E731
        tposes0, tpoints0, tobs, fixed_mask=tfixed, max_iters=iters,
        linear_solver="paired", track_pairs=pairs, costs=costs)
    blocked_d = spd_solve.BLOCKED_CALLS
    final_d, cf, launches_d, ms = run_phase("path D", lambda costs: solve_d(
        5, costs))
    blocked_d = spd_solve.BLOCKED_CALLS - blocked_d
    _log("path D", "costs " + " ".join(f"{v:.4e}" for v in cf))
    _log("path D", f"spd_solve (n = {6 * CB}): {blocked_d} of "
                   f"{launches_d['spd_solve']} calls on the large-n kernel")
    if (launches_d["spd_solve"] != final_d.it or final_d.it < 1
            or blocked_d != launches_d["spd_solve"]):
        raise AssertionError(f"path D: launches {launches_d}, {blocked_d} "
                             f"on the large-n kernel")
    _check_costs(cf, D_FINAL_COST_MAX, "path D")
    check_state(final_d, CB, LB_, "path D")
    phases["D"] = {"ms_per_lm_iter": ms, "iters": final_d.it,
                   "final_cost": cf[-1], "launches": launches_d,
                   "blocked_calls": blocked_d, "pairs": n_pairs}
    if args.profile is not None:
        _profile(lambda: solve_d(2), args.profile / "path_d.txt",
                 "path D, 2 LM iterations")
    # the system D's first step solves (n = 6144), for the kernel check
    (S_d, b_d), = captured_calls([(schur, "spd_solve")],
                                 lambda: solve_d(1))[0][:1]
    del final_d

    # ---- 11f. path P: schur_flat.solve_ba_flat "pcg" on path B's scene
    # (bench.py:1419-1455) ----
    t0 = time.perf_counter()
    work_p = schur_flat.build_flat_work(tobs, CB, LB_, dtype=f32)
    pcg_p = pcg_flat.build_pcg_work(tobs, CB, dtype=f32, n_points=LB_)
    torch.cuda.synchronize()
    _log("path P", f"slot grid K={work_p.slot.w.shape[0]} L={LB_}, camera "
                   f"table Kc={pcg_p.cam_table.shape[1]}, adjacency table "
                   f"Ka={pcg_p.adj_a.shape[1]}; built in "
                   f"{time.perf_counter() - t0:.2f} s")
    slot_p = work_p.slot
    k1p = dict(zip(k1_keys, check_assemble(
        (tposes0.R.reshape(CB, 9), tposes0.t, tpoints0, slot_p.uv0,
         slot_p.uv1, slot_p.w, slot_p.cam_of_slot), slot_p.cam_index,
        "path P")))
    final_p, cf, launches_p, ms = run_phase(
        "path P", lambda costs: schur_flat.solve_ba_flat(
            tposes0, tpoints0, tobs, work_p, fixed_mask=tfixed, max_iters=5,
            linear="pcg", pcg_work=pcg_p, cg_iters=50, cg_tol=1e-6,
            costs=costs))
    _log("path P", "costs " + " ".join(f"{v:.4e}" for v in cf))
    if launches_p["ba_assemble"] != final_p.it + 1:
        raise AssertionError(f"path P: launches {launches_p}")
    _check_costs(cf, P_FINAL_COST_MAX, "path P")
    check_state(final_p, CB, LB_, "path P")
    phases["P"] = {"ms_per_lm_iter": ms, "iters": final_p.it,
                   "final_cost": cf[-1], "launches": launches_p}
    costs_p = cf
    del final_p, work_p, pcg_p, slot_p

    # ---- 11g. path W: the sliding-window smoother on path B's scene, in
    # f32 and in f64 (the scene and its perturbation made in f64: noiseless
    # data, not f32's rounding of them). The data fix no scale: the f64
    # sweep recovers the truth up to a similarity (W_F64_ALIGNED_MAX), its
    # raw ATE is where the free scale went; the f32 sweep is held to the
    # f64 one after the same alignment (W_F32_VS_F64_MAX). Both kernels are
    # held against plain at the shapes of W's second window (its first
    # call of each, the first window with a prior), captured from the same
    # sweep cut to its first 36 cameras ----
    ate_start = float(metrics.ate_translation_rmse(tposes0, tscene.poses_true))
    ate_batch = float(metrics.ate_translation_rmse(final_b_poses,
                                                   tscene.poses_true))
    tscene64 = make_trajectory_scene(n_cams=1024, n_points=200_000,
                                     track_len=8, seed=11, dtype=f64,
                                     device=dev)
    tposes64, tpoints64, _ = perturb_scene(
        tscene64, pose_rot_noise=0.002, pose_trans_noise=0.01,
        point_noise=0.01, seed=12)
    as64 = lambda p: se3.SE3(p.R.double(), p.t.double())  # noqa: E731
    truth64 = tscene64.poses_true
    k1w, k2w, sweeps = {}, {}, {}
    for dtype_w in (f32, f64):
        name_w = str(dtype_w).rsplit(".", 1)[1]
        label = f"path W {name_w}"
        obs_w, poses0_w, points0_w = ((tscene64.obs, tposes64, tpoints64)
                                      if dtype_w == f64
                                      else (tobs, tposes0, tpoints0))
        sweep = lambda poses, **kw: sliding_window.run_sliding_window(  # noqa: E731
            obs_w, poses, points0_w, window=24, shift=12, na=8,
            max_iters=15, **kw)
        (poses_w, points_w, diag_w), _, launches_w, total_ms = run_phase(
            label, lambda costs: sweep(poses0_w), iters_of=lambda out: 1)
        n_win = len(diag_w)
        sweeps[dtype_w] = as64(poses_w)
        ate_w = float(metrics.ate_translation_rmse(sweeps[dtype_w], truth64))
        ate_al = float(metrics.ate_translation_rmse(
            metrics.align_trajectories(sweeps[dtype_w], truth64), truth64))
        iters_w = sum(d["it"] for d in diag_w)
        _log(label, f"{n_win} windows of 24 cameras (shift 12, 8 anchors), "
                    f"{iters_w} LM iterations in all, "
                    f"{statistics.mean(d['n_obs'] for d in diag_w):.0f} "
                    f"observations a window: launches {launches_w}; "
                    f"{total_ms:.1f} ms in all, {total_ms / n_win:.3f} ms a "
                    f"window (CUDA events)")
        _log(label, f"ATE (translation RMSE) {ate_w:.6e}, after the "
                    f"similarity alignment {ate_al:.6e}; perturbed start "
                    f"{ate_start:.6e}; path B's batch solve {ate_batch:.6e}")
        _log(label, "window costs " + " ".join(
            f"{d['cost0']:.3e}->{d['cost']:.3e}" for d in diag_w))
        for d in diag_w:
            if not (math.isfinite(d["cost"]) and 0 <= d["cost"] <= d["cost0"]):
                raise AssertionError(f"{label}: window {d['w0']} cost "
                                     f"{d['cost0']} -> {d['cost']}")
        if not ate_w < ate_start:
            raise AssertionError(f"{label}: ATE {ate_w} >= start {ate_start}")
        if dtype_w == f64 and not ate_al <= W_F64_ALIGNED_MAX:
            raise AssertionError(f"{label}: aligned ATE {ate_al} > "
                                 f"{W_F64_ALIGNED_MAX}")
        if (launches_w["ba_assemble"] < iters_w
                or launches_w["spd_solve"] < iters_w):
            raise AssertionError(f"{label} skipped a kernel: {launches_w}")
        if (not torch.isfinite(poses_w.t).all()
                or not torch.isfinite(points_w).all()):
            raise AssertionError(f"{label} returned non-finite state")
        phases["W_" + name_w] = {
            "ms_per_window": total_ms / n_win, "ms_total": total_ms,
            "windows": n_win, "lm_iters": iters_w, "launches": launches_w,
            "ate": ate_w, "ate_aligned": ate_al, "ate_start": ate_start,
            "ate_batch_b": ate_batch,
            "min_window_cost": min(d["cost"] for d in diag_w)}

        # the kernels at W's shapes: window 1's first call of each
        head = se3.SE3(poses0_w.R[:36], poses0_w.t[:36])
        diag_h = []
        asm_calls, spd_calls, _ = captured_calls(
            [(schur_flat_sm, "linearize_assemble"), (schur_flat, "spd_solve")],
            lambda: diag_h.extend(sweep(head)[2]))
        same = ("w0", "n_obs", "it")
        if (len(diag_h) != 2
                or any(diag_h[0][k] != diag_w[0][k] for k in same)):
            raise AssertionError(f"{label}: the first 36 cameras' sweep is "
                                 f"not the whole sweep's head: {diag_h}")
        it0 = diag_h[0]["it"]
        a_w = asm_calls[it0 + 1]
        k1w[name_w] = dict(zip(k1_keys, check_assemble(
            a_w[:7], a_w[7], f"path W {name_w} window 1", a_w[8])))
        k2w[name_w] = check_spd(*spd_calls[it0], f"path W {name_w} window 1")
        del asm_calls, spd_calls, a_w
    f32_al = metrics.align_trajectories(sweeps[f32], sweeps[f64])
    w_f32_vs_f64 = float(metrics.ate_translation_rmse(f32_al, sweeps[f64]))
    _log("path W", f"f32 sweep against the f64 sweep after the similarity "
                   f"alignment: RMSE {w_f32_vs_f64:.6e} (bound "
                   f"{W_F32_VS_F64_MAX})")
    if not w_f32_vs_f64 <= W_F32_VS_F64_MAX:
        raise AssertionError(f"path W: f32 against f64 {w_f32_vs_f64}")
    phases["W_float32"]["aligned_to_f64"] = w_f32_vs_f64
    del poses_w, points_w, pairs, tobs, sweeps, f32_al, truth64, tscene64
    del tposes64, tpoints64

    # ---- 11h. path G: schur_flat_sm at large C (bench.py:973-1050) ----
    t0 = time.perf_counter()
    gscene = make_scene(n_per_wall=1200, n_cams=1024, seed=5, dtype=f32,
                        device=dev)
    gposes0, gpoints0, gfixed = perturb_scene(gscene, 0.002, 0.01, 0.01,
                                              seed=6)
    gwork = schur_flat_sm.build_slot_work(gscene.obs, gscene.n_cams,
                                          gscene.n_points, dtype=f32,
                                          use_onehot=False)
    torch.cuda.synchronize()
    CG_, LG_, KG_ = gscene.n_cams, gscene.n_points, gwork.w.shape[0]
    _log("scene G", f"C={CG_} L={LG_} K={KG_} live observations="
                    f"{int((gwork.w > 0).sum())}; set-up "
                    f"{time.perf_counter() - t0:.2f} s")
    args_g = (gposes0.R.reshape(CG_, 9), gposes0.t, gpoints0, gwork.uv0,
              gwork.uv1, gwork.w, gwork.cam_of_slot)
    k1g = dict(zip(k1_keys, check_assemble(args_g, gwork.cam_index,
                                           "path G")))
    out_g = ba_assemble.linearize_assemble_plain(*args_g)
    S_g, b_g, *_ = schur_flat_sm.reduced_camera_system(*out_g[:5], lam,
                                                       gfixed, gwork)
    del out_g, args_g
    solve_g = lambda iters, costs=None: schur_flat_sm.solve_ba_flat_sm(  # noqa: E731
        gposes0, gpoints0, gwork, fixed_mask=gfixed, max_iters=iters,
        costs=costs)
    final_g, cf, launches_g, ms = run_phase("path G", lambda costs: solve_g(
        12, costs))
    _log("path G", "costs " + " ".join(f"{v:.4e}" for v in cf))
    if (launches_g["ba_assemble"] != final_g.it + 1
            or launches_g["spd_solve"] != final_g.it):
        raise AssertionError(f"path G skipped a kernel: {launches_g}")
    _check_costs(cf, G_FINAL_COST_MAX, "path G")
    check_state(final_g, CG_, LG_, "path G")
    check_same_bits(final_g, solve_g(12), "path G")
    phases["G"] = {"ms_per_lm_iter": ms, "iters": final_g.it,
                   "final_cost": cf[-1], "launches": launches_g}
    if args.profile is not None:
        _profile(lambda: solve_g(3), args.profile / "path_g.txt",
                 "path G, 3 LM iterations")
    del final_g, gwork, gscene

    # ---- 11i. kernel 2 at n = 6144: the systems of paths D and G ----
    k2_big = {}
    for label, S_, b_ in (("D", S_d, b_d), ("G", S_g, b_g)):
        k2_big[label] = check_spd(S_, b_, f"path {label} S")
    del S_d, b_d, S_g, b_g

    # ---- 11j. path V on converged trajectories, f64: the dense
    # covariances against the banded ones. Gated on the 20-camera scene of
    # the JAX package's own cross-check (tests/test_banded_flat.py:164-190),
    # reported on 64 cameras: there the trajectory's weak gauge (cameras 0
    # and C-1 fixed, neighbours on the circle) leaves the two exact
    # inverses apart by about the tolerance itself, the JAX package's own
    # pair as well ----
    for n_cams_v, n_points_v, track_v, seed_v in ((20, 250, 5, 85),
                                                  (64, 1200, 6, 81)):
        label = f"path V ({n_cams_v}-camera trajectory)"
        vsc = make_trajectory_scene(n_cams=n_cams_v, n_points=n_points_v,
                                    track_len=track_v, seed=seed_v,
                                    dtype=f64, device=dev)
        vp0, vx0, vfx = perturb_scene(vsc, pose_rot_noise=0.002,
                                      pose_trans_noise=0.01,
                                      point_noise=0.01, seed=seed_v + 1)
        vbw = banded_flat.build_banded_work(vsc.obs, vsc.n_cams,
                                            vsc.n_points, dtype=f64)
        vout = banded_flat.solve_ba_banded(vp0, vx0, vbw, fixed_mask=vfx,
                                           max_iters=40)
        dpc, dlc = covariance.ba_covariances(vout.poses, vout.points,
                                             vsc.obs, vfx, lam=1e-8,
                                             compute_landmarks=True)
        bpc, blc = banded_flat.banded_covariances(
            vout.poses, vout.points, vbw, vfx, lam=1e-8,
            compute_landmarks=True)
        check_covariances(dpc, dlc, vfx, vsc.obs, label)
        observed = torch.zeros(vsc.n_points, dtype=torch.bool, device=dev)
        observed[vsc.obs.lm_idx[vsc.obs.weight > 0].long()] = True
        pose_err = covariance_err(bpc, dpc, V_POSE_RTOL, V_POSE_ATOL)
        lm_err = covariance_err(blc[observed], dlc[observed], V_LM_RTOL,
                                V_LM_ATOL)
        gated = n_cams_v == 20
        _log(label, f"f64, {vout.it} LM iterations, cost "
                    f"{float(vout.cost):.3e}: banded against dense "
                    f"covariances, worst |b - d| / (atol max|d| + rtol |d|):"
                    f" poses {pose_err:.3e}, landmarks {lm_err:.3e} "
                    + ("(pass <= 1)" if gated else "(reported)"))
        if gated and not (pose_err <= 1.0 and lm_err <= 1.0):
            raise AssertionError(f"{label}: banded and dense covariances "
                                 f"differ ({pose_err}, {lm_err})")
        phases[f"V_{n_cams_v}"] = {"pose_err": pose_err, "lm_err": lm_err,
                                   "gated": gated}
    del vsc, vbw, dpc, dlc, bpc, blc

    # ---- 11k. paths Q, T, R and S: the pose graphs, spd_solve at their
    # systems' sizes ----
    k2_pg = posegraph_paths(dev, run_phase, check_spd, phases, args.profile)

    # ---- 11l. paths J, K, K64, N and U: slice D, inertial ----
    vi = inertial_paths(dev, run_phase, check_spd, phases, args.profile)

    # ---- 11m. paths Z, X, M, H, Y and RS: slice E, geometric vision ----
    geo = geometry_paths(dev, run_phase, check_spd, check_assemble, phases)

    # ---- 11n. paths FO, SD, LK, DA, ORB, CB and PAN: the image front end
    # (no kernel) ----
    fe = frontend_paths(dev, run_phase, phases)

    # ---- 11o. paths ex_*: slice H, the example programs, and the host
    # utilities on the card ----
    ex = examples_paths(dev, run_phase, check_spd, check_assemble, phases)

    # ---- 11p. paths dist_*: slice G, the distributed solvers on two gloo
    # ranks that share the card, each beside its single-process path ----
    dist_out = dist_paths(
        dev, {"A": (scene.obs, poses0, points0, fixed),
              "B": (tscene.obs, tposes0, tpoints0, tfixed),
              "L": (lobs, lposes0, lpoints0, lfixed)},
        {"A": costs_a, "B": costs_b, "L": costs_l, "P": costs_p},
        check_assemble, check_spd, phases)
    del lobs

    # ---- 11q. path BAL: the dubrovnik-solve cell's 9-wide cameras ----
    bal_out = bal_paths(dev, run_phase, check_spd, phases)

    # ---- 12. kernel 4 at its edges, against plain ----
    intr = camera.Intrinsics(458.654, 457.296, 367.215, 248.375)
    dist = camera.DistCoeffs(-0.28340811, 0.07395907, 0.0, 0.00019359,
                             1.76187114e-05)
    params = tuple(intr) + tuple(dist)
    rng_e = np.random.default_rng(5)
    for label, n_e, dtype_e, offset, iters_e, tol in (
            ("pointer 8 mod 16 bytes", 3001, f32, 1, 5, UNDISTORT_TOL),
            ("odd n below one block", 101, f32, 0, 5, UNDISTORT_TOL),
            ("odd n below one block, pointer 8 mod 16", 1, f32, 1, 5,
             UNDISTORT_TOL),
            ("n = 0", 0, f32, 0, 5, UNDISTORT_TOL),
            ("0 Newton steps", 3001, f32, 0, 0, UNDISTORT_TOL),
            ("1 Newton step", 3001, f32, 0, 1, UNDISTORT_TOL),
            ("8 Newton steps", 3001, f32, 0, 8, UNDISTORT_TOL),
            ("float64", 3001, f64, 1, 5, UNDISTORT_F64_TOL)):
        buf = torch.as_tensor(rng_e.uniform([50, 50], [700, 430],
                                            (n_e + 1, 2)),
                              dtype=dtype_e, device=dev)
        x_e = buf[offset:offset + n_e]
        out_k = undistort.undistort(x_e, params, iters_e)
        out_p = undistort.undistort_plain(x_e, params, iters_e)
        torch.cuda.synchronize()
        err_e = float((out_k - out_p).abs().max()) if n_e else 0.0
        _log("undistort", f"{label}: n={n_e} {dtype_e} {iters_e} steps, "
                          f"pointer {x_e.data_ptr() % 16} mod 16: max "
                          f"|kernel - plain| {err_e:.3e} px (bound {tol})")
        if (out_k.shape != (n_e, 2) or out_k.dtype != dtype_e
                or not err_e <= tol):
            raise AssertionError(f"undistort {label}: error {err_e} px, "
                                 f"shape {tuple(out_k.shape)}")

    # ---- 13. path E: undistortion of 8,388,608 pixels ----
    npx = 8_388_608         # bench.py:stage_undistort
    px = torch.as_tensor(np.random.default_rng(3).uniform(
        [50, 50], [700, 430], (npx, 2)), dtype=f32, device=dev)
    dist_px = camera.distort_pixels(intr, dist, px).contiguous()
    torch.cuda.synchronize()
    _reset_counts(*ops)
    und = camera.undistort_points_fast(intr, dist, dist_px)
    torch.cuda.synchronize()
    launches_e = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in ops}
    plain = undistort.undistort_plain(dist_px, params)
    k4_abs = float((und - plain).abs().max())
    trip = float((und - px).abs().max())
    _log("path E", f"{npx} px f32, 5 Newton steps: launches {launches_e}; "
                   f"max |kernel - plain| {k4_abs:.3e} px, round trip max "
                   f"|undistort(distort(px)) - px| {trip:.3e} px")
    if launches_e["undistort"] < 1:
        raise AssertionError(f"path E skipped the kernel: {launches_e}")
    if (und.shape != (npx, 2) or not torch.isfinite(und).all()
            or not k4_abs <= UNDISTORT_TOL or not trip <= ROUND_TRIP_TOL):
        raise AssertionError(f"path E: kernel error {k4_abs} px (bound "
                             f"{UNDISTORT_TOL}), round trip {trip} px (bound "
                             f"{ROUND_TRIP_TOL})")
    k4_ms, k4_plain_ms, k4_device_ms = _paired_ms(
        lambda: undistort.undistort(dist_px, params),
        lambda: undistort.undistort_plain(dist_px, params))
    k4_bound, k4_by = _bound(
        2 * _nbytes(dist_px),
        npx * (5 * undistort.FLOPS_PER_STEP + undistort.FLOPS_PER_PIXEL))
    _log("path E", f"kernel {k4_ms:.4f} ms a call ({npx / k4_ms * 1e3:.4e}"
                   f" px/s), {k4_device_ms:.4f} ms on the card alone, "
                   f"plain torch {k4_plain_ms:.4f} ms, bound {k4_bound:.4f} "
                   f"ms ({k4_by}): bound / card {k4_bound / k4_device_ms:.3f}")

    launches_of = {"A": launches_a, "B": launches_b, "L": launches_l,
                   "I": launches_i, "E": launches_e,
                   **{k: v["launches"] for k, v in phases.items()
                      if "launches" in v}, **vi["launches"],
                   **geo["launches"], **fe["launches"], **ex["launches"],
                   **dist_out["launches"]}
    by_path = {name: {path: n[name] for path, n in launches_of.items()
                      if n[name]}
               for name in ("ba_assemble", "spd_solve", "tridiag_solve")}
    kernels = [
        {"name": "ba_assemble", "route": "cuda",
         "source": "slam_tricks_tpu_torch/csrc/ba_assemble.cu",
         "replaces": "slam_tricks_tpu/ops/pallas_ba.py:47",
         "launches": sum(by_path["ba_assemble"].values()),
         "launches_by_path": by_path["ba_assemble"],
         "max_abs_err": max(k1["err"], k1b["err"], k1l["err"], k1g["err"],
                            k1p["err"], *(k["err"] for k in k1w.values()),
                            geo["assemble"]["path_X"]["err"],
                            *(k["err"] for k in ex["assemble"].values()),
                            *(k["err"]
                              for k in dist_out["assemble"].values()),
                            bal_out["assemble"]["err"]),
         "loss_max_abs_err": loss_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "device_ms": k1["device_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None, "deterministic": True,
         "segments": {"A": work.cam_index.slots.shape[0],
                      "B": bw.cam_index.slots.shape[0]},
         "path_b": {"ms": k1b["ms"], "plain_ms": k1b["plain_ms"],
                    "device_ms": k1b["device_ms"],
                    "bound_ms": k1b["bound_ms"], "bound_by": k1b["bound_by"]},
         "path_l": {"ms": k1l["ms"], "plain_ms": k1l["plain_ms"],
                    "device_ms": k1l["device_ms"],
                    "bound_ms": k1l["bound_ms"], "bound_by": k1l["bound_by"]},
         "path_b_tukey": {"ms": k1_loss["ms"], "plain_ms": k1_loss["plain_ms"],
                          "device_ms": k1_loss["device_ms"],
                          "bound_ms": k1_loss["bound_ms"],
                          "bound_by": k1_loss["bound_by"]},
         "path_g": {"ms": k1g["ms"], "plain_ms": k1g["plain_ms"],
                    "device_ms": k1g["device_ms"],
                    "bound_ms": k1g["bound_ms"], "bound_by": k1g["bound_by"]},
         "path_p": {"ms": k1p["ms"], "plain_ms": k1p["plain_ms"],
                    "device_ms": k1p["device_ms"],
                    "bound_ms": k1p["bound_ms"], "bound_by": k1p["bound_by"]},
         **{f"path_w_{name}": {key: k[key] for key in k1_keys}
            for name, k in k1w.items()},
         "path_x": geo["assemble"]["path_X"],
         **ex["assemble"], "dist": dist_out["assemble"],
         "path_bal": bal_out["assemble"]},
        {"name": "spd_solve", "route": "cuda",
         "source": "slam_tricks_tpu_torch/csrc/spd_solve.cu",
         "replaces": "slam_tricks_tpu/ops/pallas_chol.py:32",
         "launches": sum(by_path["spd_solve"].values()),
         "launches_by_path": by_path["spd_solve"],
         "max_abs_err": max(k2_abs, *(k["max_abs_err"] for k in
                                     (*k2_big.values(), *k2w.values(),
                                      *k2_pg.values(),
                                      *vi["spd"].values(),
                                      *geo["spd"].values(),
                                      *ex["spd"].values(),
                                      *dist_out["spd"].values(),
                                      *bal_out["spd"].values()))),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "device_ms": k2_device_ms,
         "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms,
         "n6144_path_d": k2_big["D"], "n6144_path_g": k2_big["G"],
         **{f"path_w_{name}": k for name, k in k2w.items()},
         **{f"path_{name}": k for name, k in k2_pg.items()},
         **vi["spd"], **geo["spd"], **ex["spd"], **dist_out["spd"],
         **bal_out["spd"]},
        {"name": "tridiag_solve", "route": "cuda",
         "source": "slam_tricks_tpu_torch/csrc/tridiag_solve.cu",
         "replaces": "slam_tricks_tpu/ops/pallas_tridiag.py:28",
         "launches": sum(by_path["tridiag_solve"].values()),
         "launches_by_path": by_path["tridiag_solve"],
         "max_abs_err": max(k3_abs, *(k["max_abs_err"] for k in (
             *vi["tridiag"].values(), *ex["tridiag"].values()))),
         "ms": k3_ms, "plain_ms": k3_plain_ms, "device_ms": k3_device_ms,
         "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib_ms,
         "m192": {"ms": kw_ms, "plain_ms": kw_plain_ms,
                  "device_ms": kw_device_ms, "bound_ms": kw_bound,
                  "bound_by": kw_by, "library_ms": kw_lib_ms},
         **{name: {**k, "launches": by_path["tridiag_solve"].get(path, 0)}
            for name, path in (("path_K_q7", "K"), ("path_K_cov_q6", "K_cov"))
            for k in (vi["tridiag"][name],)}, **ex["tridiag"]},
        {"name": "undistort", "route": "cuda",
         "source": "slam_tricks_tpu_torch/csrc/undistort.cu",
         "replaces": "slam_tricks_tpu/ops/pallas_undistort.py:23",
         "launches": launches_e["undistort"], "max_abs_err": k4_abs,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "device_ms": k4_device_ms,
         "bound_ms": k4_bound, "bound_share": k4_bound / k4_device_ms,
         "bound_by": k4_by, "library_ms": None},
    ]
    _log("run", f"wall time {time.perf_counter() - t_run0:.1f} s, the "
                f"kernels' build included")
    print(json.dumps({"kernels": kernels,
                      "ms_per_lm_iter": ms_per_iter_a,
                      "ms_per_lm_iter_b": ms_per_iter_b,
                      "ms_per_lm_iter_l": ms_per_iter_l,
                      "ms_per_arrival_i": ms_per_arrival_i,
                      "stored_factor": stored_ms,
                      "final_cost": final_a_cost,
                      "final_cost_b": final_b_cost,
                      "final_cost_l": final_l_cost,
                      "final_cost_i": final_i_cost,
                      "undistort_px_per_s": npx / k4_ms * 1e3,
                      "phases": phases}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
