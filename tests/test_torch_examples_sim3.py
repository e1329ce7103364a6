"""The port's sim3_posegraph_demo (slam_tricks_tpu_torch.examples) against
the JAX package's examples/sim3_posegraph_demo.py, both in float64 on the
CPU (the JAX example's default; the port's needs --cpu, its default is the
card in float32), in this process, the JAX side's numbers from its log
records: the drifted map's ATE and stretch to 1e-12, the Sim(3) and SE(3)
solves' ATEs, scale error and cost to rtol 1e-8; iteration counts are not
compared (both stop on the optimum's plateau, where the cost moves by
ulps: 9 against 12).
"""

import pytest

from slam_tricks_tpu_torch.examples import sim3_posegraph_demo
from tests.torch_util import run_jax_example, run_port_example


def _close(a, b, rtol):
    assert abs(a - b) <= rtol * abs(b), (a, b)


@pytest.fixture(scope="module")
def jax_sim3():
    records, _ = run_jax_example("sim3_posegraph_demo", [], "sim3_demo")
    return records


def test_sim3_posegraph_demo_matches_jax(jax_sim3):
    out, records, _ = run_port_example(sim3_posegraph_demo, ["--cpu"],
                                       "sim3_demo")
    assert len(records) == len(jax_sim3) == 3
    (drift, stretch), (ate7, s_pct, cost7, _), (ate6,) = jax_sim3
    _close(out["drift_ate"], drift, 1e-12)
    _close(out["drift_stretch"], stretch, 1e-12)
    _close(out["sim3_ate"], ate7, 1e-8)
    _close(100 * out["scale_err"], s_pct, 1e-8)
    _close(out["sim3_cost"], cost7, 1e-8)
    _close(out["se3_ate"], ate6, 1e-8)
    assert records[1][3] == out["sim3_iters"] <= 50
