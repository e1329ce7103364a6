"""device_idle_pct.dubrovnik: the share of the traced window of BAL solves
in which no kernel, copy or fill ran on the device."""

KINDS = ("closed_solves_bal",)


def read(run):
    return 100.0 * (1.0 - run.view.busy_s / run.view.window_s)
