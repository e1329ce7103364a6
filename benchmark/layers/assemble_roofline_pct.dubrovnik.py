"""assemble_roofline_pct.dubrovnik: the 9-wide linearize + assemble
layer's share of its roofline over the traced window of BAL solves: the
least time its calls' work needs (``bal_work.assemble_record``: 457
operations a live slot, W (27 a slot) written once) over the device time
of the kernels launched inside its spans."""

from benchmark.harness import bal_work

LAYER = "assemble"
KINDS = ("closed_solves_bal",)
record = bal_work.assemble_record


def read(run):
    device_s = run.view.layer_device_s(LAYER)
    calls = run.calls(__name__)
    if not device_s or not calls:
        return None
    return 100.0 * bal_work.assemble_bound_s(calls) / device_s
