"""assemble_roofline_pct.<part>: the linearize + assemble layer's share of
its roofline over the traced window: the least time its calls' work needs
(``roofline.assemble_record``) over the device time of the kernels
launched inside its spans."""

from benchmark.harness import roofline

LAYER = "assemble"
KINDS = ("closed_solves",)
record = roofline.assemble_record


def read(run):
    device_s = run.view.layer_device_s(LAYER)
    calls = run.calls(__name__)
    if not device_s or not calls:
        return None
    return 100.0 * roofline.assemble_bound_s(calls) / device_s
