"""spd_solve_roofline_pct.dubrovnik: the dense linear solve's share of its
roofline in BAL solves (n = 9 cameras): n^3 / 3 + 2 n^2 operations
(``roofline.spd_solve_flops``), or S, b and x read and written once,
whichever bounds, over the device time of the kernels launched inside its
spans."""

from benchmark.harness import roofline

LAYER = "spd_solve"
KINDS = ("closed_solves_bal",)


def record(args, kwargs):
    S, b = args[:2]
    return (roofline.nbytes(S, b, b), roofline.spd_solve_flops(S.shape[0]),
            S.element_size() == 8)


def read(run):
    device_s = run.view.layer_device_s(LAYER)
    calls = run.calls(__name__)
    if not device_s or not calls:
        return None
    bound = sum(roofline.bound_s(*c)[0] for c in calls)
    return 100.0 * bound / device_s
