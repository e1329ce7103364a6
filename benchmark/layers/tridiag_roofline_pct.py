"""tridiag_roofline_pct: the block-tridiagonal solve's share of its
roofline: a block Cholesky's operations (``roofline.tridiag_flops``), or D,
E and r read and x written once, whichever bounds, over the device time of
the kernels launched inside its spans."""

from benchmark.harness import roofline

LAYER = "tridiag"
KINDS = ("closed_solves",)


def record(args, kwargs):
    D, E, r = args[:3]
    G, m = D.shape[0], D.shape[1]
    q = r.shape[2] if r.dim() == 3 else 1
    return (roofline.nbytes(D, E, r, r), roofline.tridiag_flops(G, m, q),
            D.element_size() == 8)


def read(run):
    device_s = run.view.layer_device_s(LAYER)
    calls = run.calls(__name__)
    if not device_s or not calls:
        return None
    bound = sum(roofline.bound_s(*c)[0] for c in calls)
    return 100.0 * bound / device_s
