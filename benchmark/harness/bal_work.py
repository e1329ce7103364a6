"""The work of the BAL solver's layers, counted by the benchmark, frozen
here beside ``roofline.py`` (whose peaks and ``bound_s`` it uses):

- linearize + assemble with BAL's 9-wide camera block, a live slot:
  projection 21, distortion, residual and cost 20, Jacobians 82 (d(uv)/dp
  and its sqrt-weighting 24, the point's rows 30, the rotation's 18, the
  intrinsics' 10), W 81 (27 terms), camera sums 217 (45 + 9 terms of 3
  operations and an add, the cost), landmark sums 36: 457, beside the
  6-wide block's 271 (``roofline.ASSEMBLE_FLOPS_PER_SLOT``); bytes: the
  inputs read once, Hpp (C, 45), gp (C, 9), Hll (6, L), gl (3, L), cost
  and W (27 a slot of every grid) written once;
- the reduced camera system's pair sum: 486 operations a within-track
  pair (a <= b: 81 terms of 3 products and 3 adds) and 162 a live
  observation (Y = W Hll^-1: 27 terms of 3 and 3), or W and Hll^-1 read
  once and S (9C)² written once, whichever bounds. The pairs are counted
  from the observations that the assemble call is given, sum over the
  landmarks of k (k + 1) / 2 for a track of k, whatever the program
  sums.
"""

import numpy as np

from benchmark.harness import roofline

ASSEMBLE9_FLOPS_PER_SLOT = 457
PAIR_FLOPS = 486
OBS_FLOPS = 162


def assemble_record(args, kwargs):
    """What one call of ``linearize_assemble_grids(R_flat, t, intr, points,
    grids, loss, out)`` needs: its bytes, its grids' weights (the live
    slots are counted after the window), whether it has a loss and is
    float64."""
    R_flat, t, intr, points, grids = args[:5]
    loss = args[5] if len(args) > 5 else kwargs.get("loss")
    C, L = R_flat.shape[0], points.shape[0]
    size = points.element_size()
    n_bytes = roofline.nbytes(R_flat, t, intr, points)
    for g in grids:
        n_bytes += roofline.nbytes(g.uv0, g.uv1, g.w, g.cam_of_slot)
        n_bytes += size * 27 * g.w.numel()
    n_bytes += size * (54 * C + 9 * L + 1)
    return n_bytes, [g.w for g in grids], loss is not None, size == 8


def assemble_bound_s(records):
    """The least seconds of all recorded calls together."""
    live = {}
    total = 0.0
    for n_bytes, ws, has_loss, f64 in records:
        n = 0
        for w in ws:
            if id(w) not in live:
                live[id(w)] = int((w > 0).sum())
            n += live[id(w)]
        flops = n * (ASSEMBLE9_FLOPS_PER_SLOT
                     + has_loss * roofline.ASSEMBLE_LOSS_FLOPS_PER_SLOT)
        total += roofline.bound_s(n_bytes, flops, f64)[0]
    return total


def pair_record(args, kwargs):
    """What the pair sum's yardstick needs from a call of
    ``linearize_assemble_grids(R_flat, t, intr, points, grids, ...)``: its
    grids' weights (each column one landmark's track), the cameras and the
    dtype's size."""
    R_flat, t, intr, points, grids = args[:5]
    return [g.w for g in grids], R_flat.shape[0], points.element_size()


def pair_work(ws):
    """(within-track pairs a <= b, live observations, landmarks) of the
    observations in grids of weights ws, a landmark's track the live slots
    of its column."""
    k = np.concatenate([(w > 0).sum(0).cpu().numpy() for w in ws])
    k = k.astype(np.int64)
    return int((k * (k + 1) // 2).sum()), int(k.sum()), int(k.shape[0])


def pair_bound_s(ws, n_cams, itemsize=4):
    """The least seconds of one pair sum over the observations in grids of
    weights ws on n_cams cameras."""
    pairs, n_obs, L = pair_work(ws)
    n_bytes = itemsize * (27 * n_obs + 6 * L + (9 * n_cams) ** 2)
    return roofline.bound_s(n_bytes, PAIR_FLOPS * pairs + OBS_FLOPS * n_obs,
                            itemsize == 8)[0]
