"""The JAX package's own numbers on the configurations of chip_smoke.py's
geometric paths, on the CPU, for comparison with the port's on the card:

- X: solve_two_view on make_two_view(2000, noise=1e-3, seed=8) in f32 and
  f64: R and t/|t| against the truth, with 15 refinement iterations and 0
  (and at noise 1e-4, the noise of tests/test_initialization.py's gate);
- M: solve_pnp_batched on bench.py's 8192 x 32 batch (seed 4), f32: the
  batch's largest cost;
- H: icp_iterate on bench.py's 8192 points, 10 sweeps, f32: R and t
  against the truth.

    python3 tools/geometry_jax_reference.py      (~1 min on 8 CPU threads)
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def two_view(jax, solve_two_view, make_two_view, noise, dtype):
    s = make_two_view(n_points=2000, noise=noise, seed=8, dtype=dtype)
    t_ref = np.asarray(s.T_12.t) / np.linalg.norm(np.asarray(s.T_12.t))
    for ri in (15, 0):
        r = jax.jit(lambda a, b: solve_two_view(a, b, refine_iters=ri))(
            s.uv1, s.uv2)
        r_err = np.abs(np.asarray(r.T_12.R) - np.asarray(s.T_12.R)).max()
        t_err = np.abs(np.asarray(r.T_12.t) - t_ref).max()
        print(f"X noise {noise} {dtype.__name__} refine_iters {ri}: "
              f"|R - R_true| {r_err:.6e}, |t - t_true| {t_err:.6e}, cost "
              f"{float(r.final_cost):.6e}")


def main():
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from slam_tricks_tpu.manifolds import se3
    from slam_tricks_tpu.pipelines.two_view import solve_two_view
    from slam_tricks_tpu.residuals.icp import icp_iterate
    from slam_tricks_tpu.sim.two_view import make_two_view
    from slam_tricks_tpu.solvers.pnp import solve_pnp_batched

    for noise, dtype in ((1e-3, np.float32), (1e-3, np.float64),
                         (1e-4, np.float32)):
        two_view(jax, solve_two_view, make_two_view, noise, dtype)

    batch, n_obs = 8192, 32                       # bench.py:425-453
    rng = np.random.default_rng(4)
    f32 = np.float32
    pts = jnp.asarray(rng.uniform([-2, -2, 4], [2, 2, 8],
                                  (batch, n_obs, 3)).astype(f32))
    T_true = jax.vmap(se3.exp)(jnp.asarray(
        (rng.normal(size=(batch, 6)) * 0.2).astype(f32)))
    p_cam = jax.vmap(se3.act)(T_true, pts)
    uv = p_cam[..., :2] / p_cam[..., 2:]
    T0 = jax.vmap(se3.retract)(T_true, jnp.asarray(
        (rng.normal(size=(batch, 6)) * 0.05).astype(f32)))
    out = jax.jit(solve_pnp_batched)(T0, pts, uv)
    print(f"M f32: the batch's largest cost {float(jnp.max(out.cost)):.6e}")

    rng = np.random.default_rng(6)                # bench.py:477-505
    src = jnp.asarray(rng.normal(size=(8192, 3)).astype(f32))
    T = se3.exp(jnp.asarray([0.08, -0.05, 0.1, 0.15, -0.1, 0.05], f32))
    R, t, _, _ = jax.jit(lambda a, b: icp_iterate(a, b, n_outer=10))(
        src, se3.act(T, src))
    print(f"H f32: |R - R_true| {float(jnp.max(jnp.abs(R - T.R))):.6e}, "
          f"|t - t_true| {float(jnp.max(jnp.abs(t - T.t))):.6e}")


if __name__ == "__main__":
    main()
