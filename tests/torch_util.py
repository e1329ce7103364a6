"""Helpers of the tests that hold the torch port against the JAX package."""

import contextlib

import numpy as np
import torch

# The default test run puts 6 pytest-xdist workers on the host's cores,
# each beside XLA's own threads; torch's default of one intra-op thread a
# core in every worker oversubscribes them many times over. Every
# tests/test_torch_*.py imports this module, so the cap holds in any worker
# that runs one of them.
DEFAULT_THREADS = torch.get_num_threads()
TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)


@contextlib.contextmanager
def default_threads():
    """torch's own intra-op thread count (one a core) inside the block.
    A few parity tests compare LM stop decisions at the float64 floor,
    where the cost moves by ulps; those move with the CPU BLAS's summation
    order, and that order with the thread count."""
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(TORCH_THREADS)


def rel_err(a, b):
    """max |a - b| / max |b|, on numpy copies of tensors or arrays."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def peak_set(scores, rows, cols, ndigits=9):
    """The valid peaks of a top_k_peaks result as a set of (row, col,
    score rounded to ndigits): ties among equal scores may come in any
    order, so peaks compare as sets."""
    s = np.asarray(scores.cpu() if isinstance(scores, torch.Tensor)
                   else scores)
    r = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows)
    c = np.asarray(cols.cpu() if isinstance(cols, torch.Tensor) else cols)
    return {(int(a), int(b), round(float(v), ndigits))
            for a, b, v in zip(r, c, s) if np.isfinite(v)}
