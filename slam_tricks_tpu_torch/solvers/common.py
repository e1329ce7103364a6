"""Shared solver plumbing."""

import torch


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
