"""The port's trajectory_ba_demo (slam_tricks_tpu_torch.examples) against
the JAX package's examples/trajectory_ba_demo.py, run in this process with
the same arguments, --cpu --cams 64 --points 2000: float32 on both sides,
as the JAX example fixes it; its numbers are what it prints, rounded to 3–4
digits. 20 LM iterations on both; the robust cost to 2e-3 relative (the
print's rounding is 5e-4); the start's ATE to 4e-3 relative (its four
decimals); the measurement sigma and the middle camera's pose sigmas to
1e-2 (three digits); the final ATE below 0.5 x the start's on both and
within 25% of each other: in float32 it is rounding drift along the
scene's weakly held gauge (the port's float64 run of the same solve ends at
3.1e-4, its float32 run at 5.26e-3, the JAX package's float32 at 4.95e-3).
"""

import pytest

from slam_tricks_tpu_torch.examples import trajectory_ba_demo
from tests.torch_util import (printed_numbers, run_jax_example,
                              run_port_example)


def _close(a, b, rtol, atol=0.0):
    assert abs(a - b) <= atol + rtol * abs(b), (a, b)


@pytest.fixture(scope="module")
def jax_trajectory():
    _, out = run_jax_example("trajectory_ba_demo",
                             ["--cpu", "--cams", "64", "--points", "2000"])
    return out


def test_trajectory_ba_demo_matches_jax(jax_trajectory):
    out, _, printed = run_port_example(
        trajectory_ba_demo, ["--cpu", "--cams", "64", "--points", "2000"])
    j = printed_numbers(jax_trajectory)
    t = printed_numbers(printed)
    # scene C L track | it dt ms/iter cost | ate0 ate | sigma | cam rot trans
    assert j[:4] == t[:4] == [64, 2000, 8, 20] and out["iters"] == 20
    _close(out["cost"], j[6], 2e-3)
    _close(out["ate0"], j[7], 4e-3)
    assert out["ate"] < 0.5 * out["ate0"] and j[8] < 0.5 * j[7]
    _close(out["ate"], j[8], 0.25)
    _close(out["sigma_meas"], j[9], 1e-2)
    assert t[10] == j[10] == 32
    _close(out["rot_sigma_mid"], j[11], 1e-2)
    _close(out["trans_sigma_mid"], j[12], 1e-2)
    assert out["cov_finite"]
    # what it prints is what it returns
    assert t[6] == float(f"{out['cost']:.3e}")
    assert t[8] == float(f"{out['ate']:.6f}")
