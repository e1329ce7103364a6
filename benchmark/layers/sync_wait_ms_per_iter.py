"""sync_wait_ms_per_iter.<part>: host milliseconds an LM iteration spends
waiting for the device, inside the program's ``slam:sync.*`` spans (the
LM loop's read of its stop flag), over the LM iterations of the traced
window. It rises when the host stops setting the pace: a host that issues
faster waits longer for the same device work."""

KINDS = ("closed_solves",)
SYNC = "slam:sync."


def read(run):
    waits = [iv for name, iv in run.view.spans.items()
             if name.startswith(SYNC)]
    if not waits or not run.units:
        return None
    wait_us = sum(b - a for iv in waits for a, b in zip(iv.starts, iv.ends))
    return 1e-3 * wait_us / run.units
