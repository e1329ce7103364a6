"""Time spd_solve's two kernels against each other on the card.

    python3 tools/spd_crossover.py [--n 576 1024 1536 2048 3204] [--out DIR]

For each n, in float32 and float64: an SPD system A Aᵀ + n I made with
numpy, both kernels (``csrc/spd_solve.cu`` and ``csrc/spd_solve_blocked.cu``;
``rule_blocked`` says which one ``spd_solve.blocked_path`` picks) held to
the plain version by the residual |Sx - b| / |b|, then each timed on the
card alone (CUDA
events around 10 calls queued behind a head start of matrix products,
median of 5), with the library's Cholesky beside them. Prints a line per
(n, dtype) and the card's name and power limit; with --out, writes the lines
to DIR/spd_crossover.json. Needs a CUDA device.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from slam_tricks_tpu_torch.ops import spd_solve  # noqa: E402

RES_FACTOR = 10.0   # a kernel's residual may exceed plain's by this factor


def device_ms(fn, rounds=5, reps=10):
    """Per-call ms of fn on the card alone: the calls are queued behind
    ~60 ms of matrix products, so the host is never what the events time."""
    fn()
    torch.cuda.synchronize()
    busy = torch.ones((8192, 8192), device="cuda")
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            busy @ busy
        start.record()
        for _ in range(reps):
            fn()
        if start.query():
            raise AssertionError("head start too short")
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def residual(S, x, b):
    S64, b64 = S.double(), b.double()
    return float((S64 @ x.double() - b64).norm() / b64.norm())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[576, 1024, 1536, 2048, 3204])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("spd_crossover: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    lines = []
    for n in args.n:
        rng = np.random.default_rng(n)
        A = rng.normal(size=(n, n))
        S64 = A @ A.T + n * np.eye(n)
        b64 = rng.normal(size=n)
        for dtype in (torch.float32, torch.float64):
            S = torch.as_tensor(S64, dtype=dtype, device="cuda")
            b = torch.as_tensor(b64, dtype=dtype, device="cuda")
            res_p = residual(S, spd_solve.spd_solve_plain(S, b), b)
            eps = 1e-6 if dtype == torch.float32 else 1e-14
            line = {"n": n, "dtype": str(dtype).split(".")[1],
                    "rule_blocked": spd_solve.blocked_path(n),
                    "plain_residual": res_p}
            for key, blocked in (("small", False), ("blocked", True)):
                run = lambda: spd_solve._launch(S, b, None, blocked)  # noqa: E731
                res = residual(S, run(), b)
                if not res <= RES_FACTOR * res_p + eps:
                    raise AssertionError(f"{key} n={n} {dtype}: residual "
                                         f"{res} against plain {res_p}")
                line[f"{key}_residual"] = res
                line[f"{key}_ms"] = device_ms(run)
            line["library_ms"] = device_ms(lambda: torch.cholesky_solve(
                b[:, None], torch.linalg.cholesky_ex(S)[0]))
            print(json.dumps(line), flush=True)
            lines.append(line)
            del S, b
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "spd_crossover.json").write_text(
            json.dumps({"card": card.strip(), "lines": lines}, indent=1))


if __name__ == "__main__":
    main()
