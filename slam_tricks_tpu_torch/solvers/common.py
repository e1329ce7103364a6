"""Shared solver plumbing: full-precision products, fixed-order sums,
the sum over a process group's ranks (``psum``), the associative scan, and
the generic solvers' tangent-space linearization and damped normal-equation
solve (port of ``slam_tricks_tpu/solvers/common.py``).

Solvers linearize ``residual_fn`` through the manifold retraction at
delta = 0: r(delta) = residual_fn(retract(x, delta), *args),
J = dr/ddelta at 0, so Jacobians come out in the tangent space.
"""

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from slam_tricks_tpu_torch.ops.smallchol import cho_solve_small
from slam_tricks_tpu_torch.ops.spd_solve import spd_solve


def device_index(idx, device):
    """The ints of `idx` (a list or tuple) as an int64 tensor on `device`,
    made once a device and kept. A Python list used as an index is copied
    to the device at every use, a copy that waits for the device's queue
    and that a CUDA graph cannot capture. Never write into the result."""
    return _device_tensor(tuple(idx), torch.int64, torch.device(device))


def device_constant(values, dtype, device):
    """The numbers of `values` as a tensor of `dtype` on `device`, made once
    and kept, as ``device_index``. Never write into the result."""
    return _device_tensor(tuple(values), dtype, torch.device(device))


# unbounded: a CUDA graph that read one keeps its address (a few small
# constants a device and dtype)
@functools.lru_cache(maxsize=None)
def _device_tensor(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def set_full_precision():
    """Run float32 matrix products and convolutions in full float32.

    Gauss-Newton normal equations square the Jacobian's condition number, so
    TF32's ~3 decimal digits stall LM short of the optimum. This is the
    counterpart of the JAX package's ``Precision.HIGHEST`` pin
    (``slam_tricks_tpu/solvers/common.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def first_camera_fixed(n_cams, device):
    """The solvers' default gauge: camera 0 fixed, (C,) bool."""
    fixed_mask = torch.zeros(n_cams, dtype=torch.bool, device=device)
    fixed_mask[0] = True
    return fixed_mask


def sum_table(dest, n_rows):
    """The fixed summation order of a scatter-add, built once a layout.

    dest (N,) int64 names the row in [0, n_rows) that each of N source
    columns adds into, or -1 for a column that adds nothing. Returns an
    (n_rows, T) int64 table: row r lists the columns i with dest[i] == r in
    increasing order, padded with N (a zero column ``table_sum`` appends),
    T the most columns a row takes (at least 1)."""
    device = dest.device
    N = dest.shape[0]
    cols = torch.nonzero(dest >= 0).squeeze(1)
    rows = dest[cols]
    order = torch.argsort(rows, stable=True)
    cols, rows = cols[order], rows[order]
    counts = torch.bincount(rows, minlength=n_rows)
    T = max(int(counts.max()) if rows.numel() else 1, 1)
    rank = (torch.arange(cols.shape[0], device=device)
            - (torch.cumsum(counts, 0) - counts)[rows])
    table = torch.full((n_rows, T), N, dtype=torch.int64, device=device)
    table[rows, rank] = cols
    return table


def table_sum(src, table):
    """src (d, N) summed into the rows of ``sum_table``'s table -> (n_rows,
    d). A gather and a sum along the table's padded axis: the order of every
    sum is fixed when the table is built, so on the card the result has the
    same bits on every call, where ``index_add_`` sums by float atomics."""
    padded = torch.cat([src, src.new_zeros((src.shape[0], 1))], dim=1)
    return padded[:, table].sum(dim=-1).T


def psum(tensors, group):
    """The sums over the ranks of a ``torch.distributed`` process group of
    a tuple of float tensors of one dtype: the JAX package's
    ``jax.lax.psum(tensors, axis)``. The tensors are packed into one flat
    buffer, reduced by one ``all_reduce`` (the only collective the port
    uses: gloo, which runs ranks that share one card, reduces CUDA tensors
    with it) and split back into tensors of their shapes. group None is a
    single process: the tensors come back as they are, and no collective
    is called."""
    if group is None:
        return tuple(tensors)
    buf = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    sizes = [t.numel() for t in tensors]
    return tuple(part.view(t.shape)
                 for part, t in zip(torch.split(buf, sizes), tensors))


def associative_scan(comb, xs):
    """The inclusive prefix of the tuple of tensors `xs` (each (G, ...))
    under the associative comb(a, b) -> tuple, a the earlier element, by
    the recursion of ``jax.lax.associative_scan``: neighbours combined, the
    half-size prefix, then the even elements. ~2 log2(G) rounds of batched
    operations, combined in the JAX package's order."""
    G = xs[0].shape[0]
    if G < 2:
        return xs
    odd = associative_scan(comb, comb(tuple(x[0:-1:2] for x in xs),
                                      tuple(x[1::2] for x in xs)))
    n = (G - 1) // 2        # the even elements after the first
    even = comb(tuple(o[:n] for o in odd), tuple(x[2::2] for x in xs))
    out = []
    for x, o, e in zip(xs, odd, even):
        y = torch.empty_like(x)
        y[0::2] = torch.cat([x[:1], e])
        y[1::2] = o
        out.append(y)
    return tuple(out)


# ---- the generic NLLS solvers (solvers/lm.py) ----

class SolveResult(NamedTuple):
    """Final state of an NLLS solve."""
    x: object
    cost: torch.Tensor        # final 0.5 ||r||^2
    iterations: int           # iterations actually executed
    converged: bool           # a stop test held (not the iteration cap)
    grad_norm: torch.Tensor   # ||J^T r||_inf at the last linearization


def ata(J):
    """JᵀJ of J (k, n); run with TF32 off (``set_full_precision``)."""
    return J.mT @ J


def atb(J, r):
    """Jᵀr of J (k, n) and r (k,)."""
    return J.mT @ r


def leaves(x):
    """The tensors of a nest of tuples, lists and dicts (NamedTuples
    included), in order; any other leaf (a number, None) is skipped."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if not isinstance(x, (tuple, list)):
        return []
    return [leaf for item in x for leaf in leaves(item)]


def tree_map(f, x):
    """f on every tensor of a nest of tuples, lists and dicts, rebuilt with
    the same types (a NamedTuple by field); any other leaf (a number, None)
    is kept as it is, as ``jax.tree_util.tree_map`` leaves a static one."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if isinstance(x, dict):
        return type(x)((k, tree_map(f, v)) for k, v in x.items())
    if not isinstance(x, (tuple, list)):
        return x
    items = [tree_map(f, item) for item in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def linearize(residual_fn, manifold, x, args=()):
    """(r0 (k,), J (k, dim)) in tangent coordinates: forward-mode
    ``torch.func.jacfwd`` of r(retract(x, delta)) at delta = 0, r0 from
    the same pass, J in r0's dtype. residual_fn must not write in place.

    The cast is needed: in forward mode, a 0-d float32 tensor times a
    Python number can carry a float64 tangent (torch 2.13 on the CPU:
    ``jacfwd(lambda d: 0.25 * d[0])`` is float64), so a float32 residual
    through ``so3.log`` would give a float64 J."""
    x0 = leaves(x)[0]
    zero = torch.zeros(manifold.dim, dtype=x0.dtype, device=x0.device)

    def r_of_delta(d):
        r = residual_fn(manifold.retract(x, d), *args).reshape(-1)
        return r, r

    J, r0 = torch.func.jacfwd(r_of_delta, has_aux=True)(zero)
    return r0, J.to(r0.dtype)


def solve_damped_normal(H, g, lam, use_marquardt_scaling=True):
    """Solve (H + lam D) delta = -g, D = diag(max(diag H, 1e-12))
    (Marquardt scaling) or I, by Cholesky, for H (..., n, n) and g (..., n)
    with any leading batch dimensions: for n <= 16 the unrolled
    ``ops.smallchol`` over the whole batch, above through ``ops.spd_solve``
    (the CUDA kernel on the card), one call a problem. Returns (delta,
    bad (...)): a non-finite delta (a factor that is not positive definite
    gives NaN) becomes a zero step with bad True, the JAX package's
    semantics."""
    n = H.shape[-1]
    if use_marquardt_scaling:
        D = torch.diag_embed(torch.clamp_min(
            torch.diagonal(H, dim1=-2, dim2=-1), 1e-12))
    else:
        D = torch.eye(n, dtype=H.dtype, device=H.device)
    A = H + lam * D
    if n <= 16:
        delta = cho_solve_small(A, -g)
    elif A.dim() == 2:
        delta = spd_solve(A, -g)
    else:
        delta = torch.stack([spd_solve(a, -b) for a, b in
                             zip(A.reshape(-1, n, n), g.reshape(-1, n))]
                            ).reshape(g.shape)
    bad = ~torch.isfinite(delta).all(dim=-1)
    return torch.where(bad[..., None], torch.zeros_like(delta), delta), bad
