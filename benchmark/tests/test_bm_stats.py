"""The rate and tail arithmetic on synthetic timings."""

import pytest

from benchmark.harness import stats


def test_per_unit_ms_takes_the_whole_window():
    assert stats.per_unit_ms(2.0, 400) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        stats.per_unit_ms(1.0, 0)


def test_percentile_is_nearest_rank_over_all_values():
    vals = list(range(1, 201))          # 1 .. 200
    assert stats.percentile(vals, 95) == 190
    assert stats.percentile(vals, 100) == 200
    assert stats.percentile([7.0], 95) == 7.0


def test_a_stall_moves_both_the_rate_and_the_tail():
    # 200 solves of 100 ms and 20 iterations; then one in ten stalls 60 ms
    base = [0.1] * 200
    stalled = [0.16 if i % 10 == 0 else 0.1 for i in range(200)]
    iters = 20 * 200
    r0, r1 = (stats.per_unit_ms(sum(t), iters) for t in (base, stalled))
    p0, p1 = (1e3 * stats.percentile(t, 95) for t in (base, stalled))
    assert r1 > r0 * 1.05
    assert p1 == pytest.approx(160.0) and p0 == pytest.approx(100.0)
