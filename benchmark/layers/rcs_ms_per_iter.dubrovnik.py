"""rcs_ms_per_iter.dubrovnik: device milliseconds of the reduced camera
system (damping, whitening, the pair sum, S, the right-hand side, the
gauge and the scaling) per LM iteration of a BAL solve, from the kernels
launched inside its spans."""

LAYER = "rcs"
KINDS = ("closed_solves_bal",)


def read(run):
    device_s = run.view.layer_device_s(LAYER)
    if not device_s or not run.units:
        return None
    return 1e3 * device_s / run.units
