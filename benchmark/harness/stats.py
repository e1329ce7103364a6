"""Rate and tail arithmetic over a window's timings.

A rate is taken over all the work and all the time of the window; a tail
over every request in it. Nothing here takes medians of chunks.
"""

import math


def per_unit_ms(window_s, units):
    """Milliseconds of the window per unit of work completed in it."""
    if units <= 0:
        raise ValueError("no work completed in the window")
    return 1e3 * window_s / units


def percentile(values, q):
    """The nearest-rank q-th percentile (0 < q <= 100) of all values."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]
