"""The least time the card could take for a layer's work, frozen here.

The peaks are those of one NVIDIA H100 SXM on NVIDIA's data sheet (dense,
at the full 700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 and
34 TFLOP/s in float64 outside the tensor cores, where every layer measured
here runs. A layer's work is what its inputs need, from their shapes: each
input byte read once, each output byte written once, and the operations of
the algorithm, whatever the implementation reads again or computes twice.
Copied from ``chip_smoke.py`` (``_nbytes``, ``_bound``) and the operation
counts of ``slam_tricks_tpu_torch/ops`` as they stood when the benchmark
was written.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12

# linearize + assemble, a live slot: projection 21, residual and cost 11,
# Jacobians 40, W 54, camera sums 109, landmark sums 36
ASSEMBLE_FLOPS_PER_SLOT = 271


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_s(n_bytes, flops, f64=False):
    """(seconds, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / (F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spd_solve_flops(n):
    """Cholesky of an n x n SPD matrix and two triangular solves."""
    return n ** 3 / 3 + 2 * n ** 2


def tridiag_flops(G, m, q=1):
    """An SPD block-tridiagonal solve by block Cholesky: per block a factor
    (m^3 / 3) and, past the first, L^-1 E^T (m^3) and D - V^T V (m^3); per
    block and right-hand side ~8 m^2 (the right-hand side, the two sweeps'
    triangular solves and E^T x)."""
    return m ** 3 * G // 3 + 2 * m ** 3 * (G - 1) + 8 * m ** 2 * G * q


def assemble_record(args, kwargs):
    """What one call of ``linearize_assemble(R_flat, t, points, uv0, uv1, w,
    cam_of_slot, cam_index, loss)`` needs: its bytes (the inputs read once;
    Hpp (C, 21), gp (C, 6), Hll (6, L), gl (3, L), W (18, K, L) written
    once), its weights (the live slots are counted after the window) and
    whether it has a loss and is float64."""
    R_flat, t, points, uv0, uv1, w, cam_of_slot = args[:7]
    loss = args[8] if len(args) > 8 else kwargs.get("loss")
    C = R_flat.shape[0]
    K, L = w.shape
    n_bytes = (nbytes(R_flat, t, points, uv0, uv1, w, cam_of_slot)
               + w.element_size() * (27 * C + 9 * L + 18 * K * L))
    return n_bytes, w, loss is not None, w.dtype.itemsize == 8


# a robust loss adds, a live slot: its weight and rho (at most 9), w times
# the weight and 0.5 w rho (3)
ASSEMBLE_LOSS_FLOPS_PER_SLOT = 12


def assemble_bound_s(records):
    """The least seconds of all recorded calls together."""
    live = {}
    total = 0.0
    for n_bytes, w, has_loss, f64 in records:
        if id(w) not in live:
            live[id(w)] = int((w > 0).sum())
        flops = live[id(w)] * (ASSEMBLE_FLOPS_PER_SLOT
                               + has_loss * ASSEMBLE_LOSS_FLOPS_PER_SLOT)
        total += bound_s(n_bytes, flops, f64)[0]
    return total
