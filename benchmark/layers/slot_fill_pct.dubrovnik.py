"""slot_fill_pct.dubrovnik: the live share of the slots that the BAL
solver's layout allocates (its track-length buckets), from the program's
counters of the last layout built (``schur_bal.LIVE_SLOTS`` and
``ALLOCATED_SLOTS``); nothing where the program has no such counters."""

import sys

KINDS = ("closed_solves_bal",)
MODULE = "slam_tricks_tpu_torch.solvers.schur_bal"


def read(run):
    mod = sys.modules.get(MODULE)
    live = getattr(mod, "LIVE_SLOTS", 0)
    allocated = getattr(mod, "ALLOCATED_SLOTS", 0)
    if not live or not allocated:
        return None
    return 100.0 * live / allocated
