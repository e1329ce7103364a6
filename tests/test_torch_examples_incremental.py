"""The port's incremental_demo (slam_tricks_tpu_torch.examples) against the
JAX package's examples/incremental_demo.py, both in float64 on the CPU (the
JAX example's default; the port's needs --cpu, its default is the card in
float32), in this process, the JAX side's numbers from its log records:

- the start on 16 cameras: both at the f64 floor (~1e-28; atol 1e-20);
- each of the 6 arrivals: the camera count and the factor tail equal, the
  cost to rtol 1e-8;
- the streamed cost to rtol 1e-8 and its ATE to rtol 1e-6 (the trajectory
  scene's gauge is held weakly: exact solvers' translations drift by
  ~1e-9, ROADMAP.md's known properties);
- the rebatched and the from-scratch batch solves: both at the f64 floor
  (atol 1e-20), the rebatched ATE to rtol 1e-5 and below the streamed one:
  the rebatch solves to the floor from the two streamed states, and where
  it lands along the weak gauge moves with them (1.9e-6 relative between
  the packages).
"""

import pytest

from slam_tricks_tpu_torch.examples import incremental_demo
from tests.torch_util import run_jax_example, run_port_example

FLOOR_ATOL = 1e-20


def _close(a, b, rtol, atol=0.0):
    assert abs(a - b) <= atol + rtol * abs(b), (a, b)


@pytest.fixture(scope="module")
def jax_incremental():
    records, _ = run_jax_example("incremental_demo", [])
    return records


def test_incremental_demo_matches_jax(jax_incremental):
    out, records, _ = run_port_example(incremental_demo, ["--cpu"])
    assert len(records) == len(jax_incremental) == 9
    (a0, init_cost), *arrivals = jax_incremental[:7]
    assert a0 == records[0][0] == 16
    _close(out["init_cost"], init_cost, 0.0, FLOOR_ATOL)
    assert len(out["arrivals"]) == len(arrivals) == 6
    for (a, cost, tail), (ja, jcost, jtail) in zip(out["arrivals"],
                                                   arrivals):
        assert (a, tail) == (ja, jtail)
        _close(cost, jcost, 1e-8)
    (s_cost, s_ate), (w_cost, w_ate, b_cost) = jax_incremental[7:]
    _close(out["stream_cost"], s_cost, 1e-8)
    _close(out["stream_ate"], s_ate, 1e-6)
    _close(out["warm_cost"], w_cost, 0.0, FLOOR_ATOL)
    _close(out["batch_cost"], b_cost, 0.0, FLOOR_ATOL)
    _close(out["warm_ate"], w_ate, 1e-5)
    assert out["warm_ate"] < out["stream_ate"]
    assert records[1:7] == [tuple(a) for a in out["arrivals"]]
