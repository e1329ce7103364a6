"""SPD block-tridiagonal solve: the reduced camera system of the banded
trajectory BA, grouped into super-blocks.

``tridiag_solve(D, E, r)`` solves T x = r for T with diagonal blocks
D (G, m, m) and sub-diagonal blocks E (G-1, m, m), E[g] = T[g+1, g], and
r (G, m); it returns x (G, m). It runs the CUDA kernel
``csrc/tridiag_solve.cu`` for CUDA tensors and the plain torch version
``tridiag_solve_plain`` for CPU tensors. The kernel replaces
``slam_tricks_tpu/ops/pallas_tridiag.py::_kernel`` (called by
``tridiag_solve``): one block runs the whole two-sweep recursion. It takes
float32 and float64, any G >= 1 and any m <= 512 (``MAX_M``; the wrapper
raises beyond), with no padding of m. Its three m x m working tiles sit in
shared memory up to m = 138 in float32 and m = 97 in float64, and in a
global scratch beyond, so every band K <= 32 of the banded layout
(m = 6 K <= 192) goes through.
"""

import torch

from slam_tricks_tpu_torch.ops import _build

LAUNCHES = 0    # kernel launches since the last reset (chip_smoke.py reads it)
MAX_M = 512     # one thread a column of a tile


def tile_values(m):
    """Values of the kernel's three m x m tiles, rows padded to an odd
    stride."""
    return 3 * m * (m | 1)


def smem_bytes(m, dtype):
    """Shared memory the kernel needs to keep its tiles there for blocks of
    size m: the tiles and three vectors."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (tile_values(m) + 3 * m) * itemsize


def flops(G, m):
    """Floating-point operations an SPD block-tridiagonal solve needs (block
    Cholesky, not the kernel's Gauss-Jordan): per block a Cholesky factor
    (m^3 / 3) and, past the first, a triangular solve L^-1 E^T (m^3) and the
    symmetric update D - V^T V (m^3); per block ~8 m^2 for the right-hand
    side, the two triangular solves of each sweep and E^T x."""
    return m ** 3 * G // 3 + 2 * m ** 3 * (G - 1) + 8 * m ** 2 * G


def tridiag_solve_plain(D, E, r):
    """Plain torch version, the Pallas kernel's recursion as a loop over G:
    forward M_g = (D_g - E_{g-1} M_{g-1} E_{g-1}^T)^-1,
    u_g = M_g (r_g - E_{g-1} u_{g-1}); backward x_g = u_g - M_g E_g^T x_{g+1}.
    Each inverse goes through a Cholesky factor, so a Schur complement that
    is not positive definite gives NaN, as the JAX package's Cholesky-based
    solves do, which the solver's bad-step branch turns into a zero step.
    The kernel's unpivoted Gauss-Jordan, like the Pallas kernel's, returns
    finite values there instead; on SPD input both solve the same system.
    """
    G = D.shape[0]
    Ms, us = [], []
    for g in range(G):
        if g == 0:
            A, rhs = D[0], r[0]
        else:
            A = D[g] - E[g - 1] @ Ms[-1] @ E[g - 1].T
            rhs = r[g] - E[g - 1] @ us[-1]
        Lc, info = torch.linalg.cholesky_ex(A)
        Ms.append(torch.where(info == 0, torch.cholesky_inverse(Lc),
                              torch.full_like(A, float("nan"))))
        us.append(Ms[-1] @ rhs)
    xs = [us[-1]]
    for g in range(G - 2, -1, -1):
        xs.append(us[g] - Ms[g] @ (E[g].T @ xs[-1]))
    return torch.stack(xs[::-1])


def _launch(D, E, r):
    global LAUNCHES
    dtype, device = D.dtype, D.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tridiag_solve kernel takes float32/float64, not {dtype}")
    G, m = r.shape if r.dim() == 2 else (0, 0)
    shapes = {"D": (G, m, m), "E": (G - 1, m, m), "r": (G, m)}
    for name, a in (("D", D), ("E", E), ("r", r)):
        if (a.device != device or a.dtype != dtype
                or tuple(a.shape) != shapes[name] or not a.is_contiguous()):
            raise ValueError(
                f"tridiag_solve: {name} must be a contiguous {dtype} tensor "
                f"of shape {shapes[name]} on {device}; got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    if G < 1 or m < 1:
        raise ValueError(f"tridiag_solve: empty system G={G} m={m}")
    if m > MAX_M:
        raise ValueError(f"tridiag_solve: blocks of m={m} > {MAX_M}")
    lib = _build.library()
    M = torch.empty_like(D)      # the kernel's scratch: M_g for the backward
    x = torch.empty_like(r)
    work = None                  # tiles in shared memory, else here
    if smem_bytes(m, dtype) > _build.SMEM_PER_BLOCK:
        work = torch.empty(tile_values(m), dtype=dtype, device=device)
    fn = lib.tridiag_solve_f32 if dtype == torch.float32 else lib.tridiag_solve_f64
    with torch.cuda.device(device):
        rc = fn(D.data_ptr(), E.data_ptr(), r.data_ptr(), M.data_ptr(),
                None if work is None else work.data_ptr(), x.data_ptr(), G, m,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "tridiag_solve")
    LAUNCHES += 1
    return x


def tridiag_solve(D, E, r):
    """Solve the SPD block-tridiagonal system (D (G, m, m), E (G-1, m, m),
    r (G, m)) -> x (G, m): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if D.device.type == "cpu":
        return tridiag_solve_plain(D, E, r)
    if D.device.type != "cuda":
        raise ValueError(f"tridiag_solve: no kernel for device {D.device}")
    return _launch(D, E, r)
