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
the CPU path (paths A, B, L and I), then drives the port's five paths
through the kernels, each with every launch count set to 0 just before it:

- A, the headline bundle adjustment (st20 cube room: 96 cameras, 2400
  landmarks, 83,338 observations, 20 LM iterations, float32, TF32 off), and
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
- E, the st1 undistortion of 8,388,608 float32 pixels, 5 Newton steps
  (before it, the undistort kernel against plain at its edges: a pointer
  8 mod 16 bytes, odd counts below one block, n = 0, 0, 1 and 8 steps,
  float64);

and checks what each returns. Prints one line per phase, then a JSON line
with each kernel's launches, error, times (CUDA events, median of rounds:
`ms`, `plain_ms` and `library_ms` back to back, host included, as in every
earlier run; `device_ms` on the card alone, its calls queued behind a head
start of matrix products) and bound, the card's name and power limit from
nvidia-smi, and last the JSON status line. With --profile DIR it also writes
torch.profiler tables of paths A, B and L to DIR.

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
SPD_RES_FACTOR = 10.0       # kernel residual <= this x the plain one (+ eps)
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
UNDISTORT_TOL = 2.5e-4      # px, kernel vs plain, f32 (a few ulp at 700 px)
UNDISTORT_F64_TOL = 1e-9    # px, kernel vs plain, f64
ROUND_TRIP_TOL = 1e-3       # px, |undistort(distort(px)) - px|, f32

# peaks of one H100 SXM (NVIDIA's data sheet): the bound of each kernel,
# all of which run in float32 outside the tensor cores here
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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


def _bound(nbytes, flops):
    """The least time in ms the card could take: bytes over the memory rate
    or float32 operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
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
    rotations, translations and points."""
    import torch

    for name, a, b in (("cost", one.cost, two.cost),
                       ("rotations", one.poses.R, two.poses.R),
                       ("translations", one.poses.t, two.poses.t),
                       ("points", one.points, two.points)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: two runs differ in the {name}")
    _log(label, f"a second run: the same bits in the cost ({float(two.cost)!r}"
                f"), rotations, translations and points")


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="write torch.profiler tables of paths A and B here")
    args = ap.parse_args()

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
    from slam_tricks_tpu_torch.solvers import (banded_flat, incremental,
                                               loop_flat, schur_flat_sm)
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

    def check_assemble(args_, index, label, loss=None, timed=True):
        """Kernel 1 against plain on args_ (the kernel with the layout's
        camera index), and two launches against each other bitwise; with
        `timed`, returns (max |k - p|, ms, plain ms, device ms, bound ms,
        bound_by), else (max |k - p|,)."""
        out_k = ba_assemble.linearize_assemble(*args_, index, loss)
        out_p = ba_assemble.linearize_assemble_plain(*args_, loss)
        out_k2 = ba_assemble.linearize_assemble(*args_, index, loss)
        torch.cuda.synchronize()
        if loss is not None:
            label = f"{label} {loss.kind}({loss.param:g})"
        err = 0.0
        for name, a, b, a2 in zip(("Hpp", "gp", "Hll", "gl", "W", "cost"),
                                  out_k, out_p, out_k2):
            rel = _rel(a, b)
            err = max(err, float((a - b).abs().max()))
            _log("ba_assemble", f"{label} {name} {tuple(a.shape)} max rel err "
                                f"{rel:.3e}")
            if not rel <= ASSEMBLE_REL_TOL:
                raise AssertionError(f"ba_assemble {label} {name}: rel err "
                                     f"{rel} > {ASSEMBLE_REL_TOL}")
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
            _nbytes(*args_, *out_k[:4]) + _nbytes(out_k[4]), live * flops)
        _log("ba_assemble", f"{label}: kernel {ms:.4f} ms a call "
                            f"({device_ms:.4f} ms on the card alone); plain "
                            f"torch {plain_ms:.4f} ms, bound {bound_ms:.4f} "
                            f"ms ({bound_by})")
        return err, ms, plain_ms, device_ms, bound_ms, bound_by

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
        G, m = D.shape[0], D.shape[1]
        T = torch.zeros((G, m, G, m), dtype=f64, device=dev)
        gi = torch.arange(G, device=dev)
        T[gi, :, gi, :] = D.double()
        if G > 1:
            T[gi[:-1] + 1, :, gi[:-1], :] = E.double()
            T[gi[:-1], :, gi[:-1] + 1, :] = E.double().transpose(1, 2)
        return T.reshape(G * m, G * m)

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

    kernels = [
        {"name": "ba_assemble", "route": "cuda",
         "source": "slam_tricks_tpu_torch/csrc/ba_assemble.cu",
         "replaces": "slam_tricks_tpu/ops/pallas_ba.py:47",
         "launches": sum(n["ba_assemble"] for n in (launches_a, launches_b,
                                                     launches_l, launches_i)),
         "launches_by_path": {"A": launches_a["ba_assemble"],
                              "B": launches_b["ba_assemble"],
                              "L": launches_l["ba_assemble"],
                              "I": launches_i["ba_assemble"]},
         "max_abs_err": max(k1["err"], k1b["err"], k1l["err"]),
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
                          "bound_by": k1_loss["bound_by"]}},
        {"name": "spd_solve", "route": "cuda",
         "source": "slam_tricks_tpu_torch/csrc/spd_solve.cu",
         "replaces": "slam_tricks_tpu/ops/pallas_chol.py:32",
         "launches": launches_a["spd_solve"], "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "device_ms": k2_device_ms,
         "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms},
        {"name": "tridiag_solve", "route": "cuda",
         "source": "slam_tricks_tpu_torch/csrc/tridiag_solve.cu",
         "replaces": "slam_tricks_tpu/ops/pallas_tridiag.py:28",
         "launches": launches_b["tridiag_solve"] + launches_i["tridiag_solve"],
         "launches_by_path": {"B": launches_b["tridiag_solve"],
                              "I": launches_i["tridiag_solve"]},
         "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "device_ms": k3_device_ms,
         "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib_ms,
         "m192": {"ms": kw_ms, "plain_ms": kw_plain_ms,
                  "device_ms": kw_device_ms, "bound_ms": kw_bound,
                  "bound_by": kw_by, "library_ms": kw_lib_ms}},
        {"name": "undistort", "route": "cuda",
         "source": "slam_tricks_tpu_torch/csrc/undistort.cu",
         "replaces": "slam_tricks_tpu/ops/pallas_undistort.py:23",
         "launches": launches_e["undistort"], "max_abs_err": k4_abs,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "device_ms": k4_device_ms,
         "bound_ms": k4_bound, "bound_share": k4_bound / k4_device_ms,
         "bound_by": k4_by, "library_ms": None},
    ]
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
                      "undistort_px_per_s": npx / k4_ms * 1e3}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
