"""lm_host_ms_per_iter.<part>: host milliseconds an LM iteration takes to
issue its work: the time inside the program's ``slam:lm.iter`` spans less
the time inside the ``slam:sync.*`` spans they hold (the host's waits for
the device), over the LM iterations of the traced window."""

KINDS = ("closed_solves",)
ITER = "slam:lm.iter"
SYNC = "slam:sync."


def read(run):
    spans = run.view.spans
    it = spans.get(ITER)
    if it is None or not run.units:
        return None
    host_us = sum(b - a for a, b in zip(it.starts, it.ends))
    for name, iv in spans.items():
        if name.startswith(SYNC):
            host_us -= sum(b - a for a, b in zip(iv.starts, iv.ends)
                           if it.holds(a))
    return 1e-3 * host_us / run.units
