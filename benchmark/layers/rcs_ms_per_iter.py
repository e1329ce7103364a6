"""rcs_ms_per_iter.<part>: device milliseconds of the reduced camera
system (damping, whitening, S or its bands, the right-hand side, the
gauge) per LM iteration, from the kernels launched inside its spans."""

LAYER = "rcs"
KINDS = ("closed_solves",)


def read(run):
    device_s = run.view.layer_device_s(LAYER)
    if not device_s or not run.units:
        return None
    return 1e3 * device_s / run.units
