"""Benchmark of slam_tricks_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs the cell's set-up (scene, the program's layout, its kernel library,
built into the checkout's build/kernels/ on a first run, and one warm-up
solve), then with --trace 0 measures for --seconds and prints
the cell's end-to-end metrics, with --trace 1 profiles the traffic file's
traced amount and prints its per-layer metrics. Either way it then checks a
sample of what the window produced against the plain reference and prints
one JSON line last: correct, attempted, failed, metrics, device,
(breakdown,) checks.

It needs a CUDA card: without one, or with fewer than the cell asks for, it
exits with an error and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PACKAGE = "slam_tricks_tpu_torch"


def cache_env(root=ROOT):
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "2"


def _clean(x):
    """JSON-safe: non-finite floats become None."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    return x


def fail(msg):
    print(f"run.py: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import manifest

    try:
        cell = manifest.Cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        fail(str(exc))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the benchmark measures the "
             "program on a CUDA card and has no CPU fallback")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA devices, "
             f"{torch.cuda.device_count()} visible")
    if not (ROOT / PACKAGE / "csrc").is_dir():
        fail(f"no {PACKAGE}/ in {ROOT}: run from a checkout of the repo")
    import importlib
    pkg = importlib.import_module(PACKAGE)
    if Path(pkg.__file__).resolve().parents[1] != ROOT:
        fail(f"imported {PACKAGE} from {pkg.__file__}, not this checkout")

    from benchmark.harness import runner
    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             T_START)
    found = runner.forbidden_modules()
    if found:
        fail(f"forbidden modules loaded in the process: {found}")
    print(json.dumps(_clean(result), allow_nan=False), flush=True)


if __name__ == "__main__":
    main()
