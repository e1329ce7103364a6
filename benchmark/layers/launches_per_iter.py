"""launches_per_iter.<part>: host calls that launch work on the device
(kernel, cooperative-kernel and graph launches alike) per LM iteration,
over a batch solve's traced window."""

KINDS = ("closed_solves",)


def read(run):
    if not run.view.launches or not run.units:
        return None
    return len(run.view.launches) / run.units
