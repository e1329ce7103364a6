"""The sliding-window sweep of path W in float32 and float64, and what
float32 does to its marginalization prior.

    python3 tools/sweep_precision.py [--device cuda|cpu] [--cams 1024]
        [--threads N] [--prior-dtype float64|window] [--out FILE]

Runs ``sliding_window.run_sliding_window`` on path W's configuration
(``chip_smoke.py``: the trajectory scene of path B, 195 landmarks a camera,
tracks of 8, perturbed by (0.002, 0.01, 0.01), windows of 24, shift 12, 8
anchors, 15 iterations a window; --cams cuts the trajectory) with float32
and with float64 windows. --prior-dtype window forms and evaluates the
prior in the window's dtype, as the JAX package does, instead of the
port's float64 (``sliding_window.PRIOR_DTYPE``). For each sweep it prints
the translation RMSE against the truth (ATE) before and after the
similarity alignment that the data leave free (``metrics.
align_trajectories``), the windows whose final cost is negative (a prior
that is not positive semi-definite), the least eigenvalue over the
priors (over their largest), and the float32 sweep against the float64
one after the same alignment; then one JSON line, also written to --out.
On the CPU, --threads sets torch's threads (the order of its sums).
Imports nothing of JAX.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cams", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--prior-dtype", choices=("float64", "window"),
                    default="float64")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    sys.path.insert(0, str(ROOT))
    from slam_tricks_tpu_torch.evaluation import metrics
    from slam_tricks_tpu_torch.manifolds import se3
    from slam_tricks_tpu_torch.sim import make_trajectory_scene, perturb_scene
    from slam_tricks_tpu_torch.solvers import sliding_window

    if args.threads is not None:
        torch.set_num_threads(args.threads)
    as64 = lambda p: se3.SE3(p.R.double(), p.t.double())  # noqa: E731
    marginalize = sliding_window.marginalize
    result = {"device": args.device, "cams": args.cams,
              "threads": torch.get_num_threads(),
              "prior_dtype": args.prior_dtype, "sweeps": {}}
    if args.device == "cuda":
        import subprocess
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    poses = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).rsplit(".", 1)[1]
        sliding_window.PRIOR_DTYPE = (torch.float64
                                      if args.prior_dtype == "float64"
                                      else dtype)
        least = []

        def record(*a, **kw):
            out = marginalize(*a, **kw)
            ev = torch.linalg.eigvalsh(out[0].H.double())
            least.append(float(ev[0] / ev[-1]))
            return out

        sliding_window.marginalize = record
        sc = make_trajectory_scene(n_cams=args.cams,
                                   n_points=195 * args.cams, track_len=8,
                                   seed=11, dtype=dtype, device=args.device)
        p0, x0, _ = perturb_scene(sc, pose_rot_noise=0.002,
                                  pose_trans_noise=0.01, point_noise=0.01,
                                  seed=12)
        t0 = time.perf_counter()
        try:
            out, _, diag = sliding_window.run_sliding_window(
                sc.obs, p0, x0, window=24, shift=12, na=8, max_iters=15)
        finally:
            sliding_window.marginalize = marginalize
        seconds = time.perf_counter() - t0
        truth = as64(sc.poses_true)
        poses[name] = as64(out)
        ate = float(metrics.ate_translation_rmse(poses[name], truth))
        aligned = float(metrics.ate_translation_rmse(
            metrics.align_trajectories(poses[name], truth), truth))
        ate0 = float(metrics.ate_translation_rmse(as64(p0), truth))
        negative = [d["w0"] for d in diag if d["cost"] < 0]
        result["sweeps"][name] = {
            "seconds": seconds, "windows": len(diag), "ate_start": ate0,
            "ate": ate, "ate_aligned": aligned,
            "negative_cost_windows": negative,
            "least_eigenvalue_ratio": min(least)}
        print(f"{name} windows: {len(diag)} windows in {seconds:.1f} s; ATE "
              f"{ate!r} (start {ate0!r}), aligned {aligned!r}; windows with "
              f"a negative cost {negative}; least prior eigenvalue / "
              f"largest {min(least)!r}", flush=True)
    al = metrics.align_trajectories(poses["float32"], poses["float64"])
    result["f32_vs_f64_aligned"] = float(
        metrics.ate_translation_rmse(al, poses["float64"]))
    print(f"float32 sweep against float64, aligned: "
          f"{result['f32_vs_f64_aligned']!r}", flush=True)
    if "card" in result:
        print(result["card"])
    line = json.dumps(result)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
