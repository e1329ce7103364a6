"""backsub_retract_ms_per_iter.<part>: device milliseconds an LM iteration
of the work launched inside the program's ``slam:backsub`` (the landmark
back-substitution) and ``slam:lm.retract`` (the finiteness guard and the
step on SO(3) x R^3) spans, over the LM iterations of the traced window."""

KINDS = ("closed_solves",)
SPANS = ("slam:backsub", "slam:lm.retract")


def read(run):
    view = run.view
    spans = [view.spans.get(name) for name in SPANS]
    if None in spans or not run.units:
        return None
    device_us = sum(e["dur"] for e, ts in zip(view.device, view.launch_of)
                    if ts is not None and any(iv.holds(ts) for iv in spans))
    return 1e-3 * device_us / run.units
