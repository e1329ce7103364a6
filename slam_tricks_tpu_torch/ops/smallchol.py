"""Unrolled Cholesky factor and solves of small SPD systems, batched over
the leading dimensions (port of ``slam_tricks_tpu/ops/smallchol.py``).

The loops run over the static size n (3 or 6 here), so each step is one
elementwise operation over the whole batch; plain torch, not a kernel.
"""

import torch


def cholesky_small(A):
    """Lower Cholesky factor of (..., n, n) SPD, unrolled for static n; NaN
    where a pivot is negative (the square root of it)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def solve_lower_small(L, B):
    """Solve L X = B for lower-triangular L (..., n, n), B (..., n, k)."""
    n = L.shape[-1]
    x = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * x[k]
        x[i] = s / L[..., i, i, None]
    return torch.stack(x, dim=-2)


def solve_lower_t_small(L, B):
    """Solve Lᵀ X = B for lower-triangular L (..., n, n), B (..., n, k)."""
    n = L.shape[-1]
    x = [None] * n
    for i in reversed(range(n)):
        s = B[..., i, :]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    return torch.stack(x, dim=-2)


def cho_solve_small(A, b):
    """Solve A x = b for SPD A (..., n, n) and b (..., n): the unrolled
    Cholesky factor, then the forward and the back substitution."""
    n = A.shape[-1]
    L = cholesky_small(A)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)
