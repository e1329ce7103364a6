"""device_idle_pct.<part>: the share of the traced window in which no
kernel, copy or fill ran on the device."""

KINDS = ("closed_solves",)


def read(run):
    return 100.0 * (1.0 - run.view.busy_s / run.view.window_s)
