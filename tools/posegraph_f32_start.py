"""bench.py's pose graph made in float32, and the relative-state solvers
of the JAX package and of the port on it, on the CPU.

    python3 tools/posegraph_f32_start.py [--N 10000] [--loops 64]
        [--iters 80] [--out FILE]

bench.py:stage_posegraph makes its graph (seed 17, odometry noise 0.002,
loop noise 0.0005) in float32 and integrates the start in float64 from
the float32 measurements, so the start's rotations drift off orthonormal
by what the rounding of those measurements leaves, summed over N of them.
The script makes the graph twice: with XLA's rounding of the float32
products (a fused multiply-add chain; ``chip_smoke.circle_graph``, the
bench's graph to an ulp) and with torch's unfused CPU products (how the
port's own group functions would make it). On each it runs the JAX
package's ``solve_pose_graph_relative`` under ``jax.jit``, as the bench
runs it, and the port's, from the same float32 inputs, and prints one JSON
line a run: the start's distance from orthonormal (max |RᵀR - I|), the
cost and ATE (the RMS over all coordinates, as the bench's) before and
after, and the iterations; then one JSON line of all runs, also written to
--out. Imports JAX on the CPU and the port; runs in a few minutes at the
bench's N.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=10_000)
    ap.add_argument("--loops", type=int, default=64)
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke
    from slam_tricks_tpu.manifolds import se3 as jse3
    from slam_tricks_tpu.solvers import posegraph as jpg
    from slam_tricks_tpu_torch.solvers import posegraph as pg

    def torch_dot3(A, B):
        return (torch.from_numpy(A) @ torch.from_numpy(B)).numpy()

    jsolve = jax.jit(jpg.solve_pose_graph_relative,
                     static_argnames=("max_iters",))
    runs = []
    for rounding in ("xla", "torch"):
        if rounding == "torch":
            chip_smoke._dot3 = torch_dot3
        t_true, p0, ii, jj, Z, info = chip_smoke.circle_graph(
            args.N, args.loops, seed=17, odo_noise=0.002, loop_noise=0.0005,
            dtype=np.float32, device="cpu")
        t_true = t_true.numpy()
        R0 = p0.R.double().numpy()
        off = float(np.abs(np.swapaxes(R0, -1, -2) @ R0 - np.eye(3)).max())
        ate = lambda t: float(np.sqrt(np.mean(  # noqa: E731
            (np.asarray(t, np.float64) - t_true) ** 2)))
        work = pg.build_chain_work(ii, jj, Z, info, args.N,
                                   dtype=torch.float32, device="cpu")
        jw = jpg.build_chain_work(ii.numpy(), jj.numpy(),
                                  jse3.SE3(jnp.asarray(Z.R.numpy()),
                                           jnp.asarray(Z.t.numpy())),
                                  jnp.asarray(info.numpy()), args.N,
                                  dtype=np.float32)
        jp0 = jse3.SE3(jnp.asarray(p0.R.numpy()), jnp.asarray(p0.t.numpy()))
        for solver in ("jax", "port"):
            t = time.time()
            costs = []
            if solver == "jax":
                out = jax.block_until_ready(
                    jsolve(jp0, jw, max_iters=args.iters))
                cost0 = float(jsolve(jp0, jw, max_iters=0).cost)
            else:
                out = pg.solve_pose_graph_relative(
                    p0, work, max_iters=args.iters, costs=costs)
                cost0 = float(costs[0])
            row = {"rounding": rounding, "solver": solver, "N": args.N,
                   "loops": args.loops, "start_off_orthonormal": off,
                   "cost_start": cost0, "cost": float(out.cost),
                   "iters": int(out.it), "ate_start": ate(p0.t),
                   "ate": ate(out.poses.t), "seconds": time.time() - t}
            print(json.dumps(row), flush=True)
            runs.append(row)
    line = json.dumps({"posegraph_f32_start": runs})
    print(line)
    if args.out:
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
