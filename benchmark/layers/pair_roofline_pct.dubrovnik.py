"""pair_roofline_pct.dubrovnik: the reduced camera system's pair sum's
share of its roofline in BAL solves: the least time of one sum
(``bal_work.pair_bound_s``: 486 operations a within-track pair counted
from the observations that the run's assemble calls are given, 162 a
live observation, or W and Hll^-1 read and S written once), times the
sums in the window, over the device time of the kernels launched inside
the program's ``slam:rcs.pairs`` spans; nothing where the program has no
such span."""

from benchmark.harness import bal_work

LAYER = "assemble"
KINDS = ("closed_solves_bal",)
SPAN = "slam:rcs.pairs"
record = bal_work.pair_record


def read(run):
    view = run.view
    iv = view.spans.get(SPAN)
    calls = run.calls(__name__)
    if iv is None or not calls:
        return None
    device_us = sum(e["dur"] for e, ts in zip(view.device, view.launch_of)
                    if ts is not None and iv.holds(ts))
    if not device_us:
        return None
    bound = bal_work.pair_bound_s(*calls[0])
    return 100.0 * bound * view.span_calls[SPAN] / (1e-6 * device_us)
