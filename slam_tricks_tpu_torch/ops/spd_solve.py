"""Dense SPD solve S x = b of the reduced camera system.

``spd_solve`` runs a CUDA kernel for CUDA tensors and the plain torch
version ``spd_solve_plain`` for CPU tensors. Both kernels replace
``slam_tricks_tpu/ops/pallas_chol.py::_kernel`` (called by
``chol_solve_padded`` / ``chol_solve``): a right-looking tiled Cholesky
with a lookahead, S = UᵀU read from the upper triangle of S, with both
substitutions fused, in one cooperative launch of a persistent grid (at
most one block an SM, one grid barrier a tile row), working on a
device-memory copy of S. Which one runs is a rule on n alone
(``blocked_path``): below ``BLOCKED_MIN_N``, ``csrc/spd_solve.cu``, 32 x 32
tiles, bound by the chain of tile rows; from it on,
``csrc/spd_solve_blocked.cu``, 64-row panels run ahead of register-blocked
trailing updates on every SM, bound by the updates. n needs no padding.
Both take float32 and float64 and any n <= ``MAX_N`` = 46340, where n²
still fits the small kernel's 32-bit element offsets (the large kernel's
padded copy, (64 ceil(n / 64))², fits unsigned 32-bit ones); shared memory
does not bound n.

On a matrix that is not positive definite (a pivot <= 0 or not finite)
both return NaN, as the JAX package's default XLA Cholesky and
``tridiag_solve`` do, and the solver's ``bad`` branch turns the step into a
zero step; the Pallas kernel clamped pivots at 1e-30 and returned finite
values.
"""

import torch

from slam_tricks_tpu_torch.ops import _build

LAUNCHES = 0        # kernel launches since the last reset (chip_smoke.py reads it)
BLOCKED_CALLS = 0   # of those, the calls that took the large-n kernel

MAX_N = 46340   # n * n < 2**31: the kernel's element offsets are 32-bit ints
TILE = 32       # spd_solve.cu's tile: a lane a column
BLOCKED_TILE = 64   # spd_solve_blocked.cu's tile row
# The crossover, measured on the H100 (PERF.md §6): spd_solve_blocked.cu
# is faster from n = 768 in float32 and from 1536 in float64 (at 1280 it
# takes 0.699 ms to spd_solve.cu's 0.604); from 1536 on, in both. Every
# n <= 672 the port's solvers use stays on spd_solve.cu.
BLOCKED_MIN_N = 1536


def blocked_path(n):
    """True where an n x n system takes the large-n kernel."""
    return n >= BLOCKED_MIN_N


def spd_solve_plain(S, b):
    """Plain torch version: Cholesky factor and solve, NaN where S is not
    positive definite. S (n, n), b (n,) -> x (n,)."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def check_size(n):
    """Raise unless the kernel takes an n x n system."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"spd_solve: n={n} is outside the kernel's "
                         f"1 <= n <= {MAX_N}")


def _check_out(out, b, name):
    """Raise unless out can take the solution of right-hand side b."""
    if (out.shape != b.shape or out.dtype != b.dtype
            or out.device != b.device or not out.is_contiguous()):
        raise ValueError(
            f"{name}: out must be a contiguous {b.dtype} tensor of shape "
            f"{tuple(b.shape)} on {b.device}; got {out.dtype} "
            f"{tuple(out.shape)} on {out.device}")


def _launch(S, b, out, blocked):
    global LAUNCHES, BLOCKED_CALLS
    dtype, device = S.dtype, S.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spd_solve kernel takes float32/float64, not {dtype}")
    if S.dim() != 2:
        raise ValueError(f"spd_solve: S must be (n, n), got {tuple(S.shape)}")
    n = S.shape[0]
    check_size(n)
    if (S.shape[1] != n or not S.is_contiguous() or b.shape != (n,)
            or b.dtype != dtype or b.device != device
            or not b.is_contiguous()):
        raise ValueError(
            f"spd_solve: need contiguous S (n, n) and b (n,) of one dtype on "
            f"one device; got S {tuple(S.shape)} {S.dtype} {S.device}, "
            f"b {tuple(b.shape)} {b.dtype} {b.device}")
    lib = _build.library()
    tile = BLOCKED_TILE if blocked else TILE
    nt = -(-n // tile)
    # the factor's scratch: the copy of S (padded to whole tiles on the
    # large path), then nt diagonal tiles; y and z of the same length
    m = nt * tile if blocked else n
    A = torch.empty(m * m + nt * tile * tile, dtype=dtype, device=device)
    yz = torch.empty(2 * m, dtype=dtype, device=device)
    if out is not None:
        _check_out(out, b, "spd_solve")
    x = torch.empty_like(b) if out is None else out
    # the back substitution's flags; on the large path, a tile counter a step
    flags = torch.empty(2 * nt if blocked else nt, dtype=torch.int32,
                        device=device)
    name = "spd_solve_blocked" if blocked else "spd_solve"
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(device):
        rc = fn(S.data_ptr(), b.data_ptr(), A.data_ptr(), yz.data_ptr(),
                x.data_ptr(), flags.data_ptr(), n,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, name)
    LAUNCHES += 1
    BLOCKED_CALLS += blocked
    return x


def spd_solve(S, b, out=None):
    """Solve S x = b for SPD S (n, n), b (n,): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. out: a tensor like b that
    takes x (returned), or None."""
    if S.device.type == "cpu":
        x = spd_solve_plain(S, b)
        if out is None:
            return x
        _check_out(out, b, "spd_solve")
        return out.copy_(x)
    if S.device.type != "cuda":
        raise ValueError(f"spd_solve: no kernel for device {S.device}")
    return _launch(S, b, out, blocked_path(S.shape[0]))
