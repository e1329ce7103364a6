"""The readings that a cell's limits are set from (``limits/<cell>.json``):
the numbers the check compares, for a run of seeds of the program, of the
control (the reference in float32 with TF32 in the program's place) and
of each fault the traffic kind plants (``FAULTS`` of ``kinds/<kind>.py``),
each seed driving the traffic's check amount through the timed path.
Set-up is made once a side; every seed draws its own starts.

    python3 benchmark/calibrate.py --workload <name> --seed0 <n> \\
        --seeds 12 --control-seeds 3 --fault-seeds 3

Prints one JSON line a seed: side, seed, failed, the program's own worst
final cost, the compared numbers. Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibrate.py: needs a CUDA card")
    from benchmark.harness import manifest, runner

    cell = manifest.Cell(args.workload)
    device = torch.device("cuda", 0)
    sides = [("program", None, args.seeds), ("control", None,
                                             args.control_seeds)]
    sides += [(name, name, args.fault_seeds) for name in cell.kind.FAULTS]
    for n_side, (side, fault, n) in enumerate(sides):
        adapter = ctx = None
        for k in range(n):
            seed = args.seed0 + 1000 * n_side + k
            t0 = time.perf_counter()
            scene, fixed, adapter, ctx, loop = runner.prepare(
                cell, seed, device, side == "control", adapter, ctx, fault)
            if k == 0:
                loop.warm_up()
            win = loop.run(count=int(cell.traffic["check"]["count"]))
            outputs = cell.kind.outputs(loop, win.samples)
            numbers = runner.numbers_of(cell, loop, scene, fixed, outputs,
                                        device, lambda m: None)
            print(json.dumps({"side": side, "seed": seed,
                              "failed": win.failed, "worst": win.worst,
                              "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
