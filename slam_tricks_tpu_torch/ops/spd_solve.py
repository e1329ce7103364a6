"""Dense SPD solve S x = b of the reduced camera system.

``spd_solve`` runs the CUDA kernel ``csrc/spd_solve.cu`` for CUDA tensors and
the plain torch version ``spd_solve_plain`` for CPU tensors. The kernel
replaces ``slam_tricks_tpu/ops/pallas_chol.py::_kernel`` (called by
``chol_solve_padded`` / ``chol_solve``): a right-looking tiled Cholesky
with a lookahead, S = UᵀU read from the upper triangle of S, with both
substitutions fused, in one cooperative launch of a persistent grid (at
most one block an SM, one grid barrier a tile row). It works in place on a
device-memory copy of S cut into 32 x 32 tiles; n needs no padding. It
takes float32 and float64 and any n <= ``MAX_N`` = 46340, where n² still
fits the kernel's 32-bit element offsets; shared memory does not bound n.

On a matrix that is not positive definite (a pivot <= 0 or not finite)
both return NaN, as the JAX package's default XLA Cholesky and
``tridiag_solve`` do, and the solver's ``bad`` branch turns the step into a
zero step; the Pallas kernel clamped pivots at 1e-30 and returned finite
values.
"""

import torch

from slam_tricks_tpu_torch.ops import _build

LAUNCHES = 0    # kernel launches since the last reset (chip_smoke.py reads it)

MAX_N = 46340   # n * n < 2**31: the kernel's element offsets are 32-bit ints
TILE = 32       # the kernel's tile: a lane a column


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


def _launch(S, b, out=None):
    global LAUNCHES
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
    nt = -(-n // TILE)
    # the factor's scratch: the copy of S, then the nt inverted diagonal tiles
    A = torch.empty(n * n + nt * TILE * TILE, dtype=dtype, device=device)
    yz = torch.empty(2 * n, dtype=dtype, device=device)
    if out is not None:
        _check_out(out, b, "spd_solve")
    x = torch.empty_like(b) if out is None else out
    flags = torch.empty(nt, dtype=torch.int32, device=device)
    fn = lib.spd_solve_f32 if dtype == torch.float32 else lib.spd_solve_f64
    with torch.cuda.device(device):
        rc = fn(S.data_ptr(), b.data_ptr(), A.data_ptr(), yz.data_ptr(),
                x.data_ptr(), flags.data_ptr(), n,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "spd_solve")
    LAUNCHES += 1
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
    return _launch(S, b, out)
