"""SPD block-tridiagonal solve: the reduced camera system of the banded
trajectory BA, grouped into super-blocks.

``tridiag_solve(D, E, r)`` solves T x = r for T with diagonal blocks
D (G, m, m) and sub-diagonal blocks E (G-1, m, m), E[g] = T[g+1, g], and
r (G, m), or q right-hand sides at once, r (G, m, q) with q <= 16
(``MAX_Q``); it returns x of r's shape. It runs the CUDA kernel
``csrc/tridiag_solve.cu`` for CUDA tensors and the plain torch version
``tridiag_solve_plain`` for CPU tensors. The kernel replaces
``slam_tricks_tpu/ops/pallas_tridiag.py::_kernel`` (called by
``tridiag_solve``) with block cyclic reduction, the JAX package's default
(``banded_flat._block_tridiag_cr_multi``), in one cooperative launch of a
persistent grid: log2(G) levels, the odd rows of a level eliminated at once
by one block each, three grid barriers a level. It takes float32 and float64,
any G >= 1 (odd G and odd levels included, with no padding) and any
m <= 512 (``MAX_M``; the wrapper raises beyond), with no padding of m. A
block's working tile sits in shared memory while it fits (one right-hand
side: up to m = 128 in float32 and m = 96 in float64), and in a global
scratch beyond, so every band K <= 32 of the banded layout (m = 6 K <= 192)
goes through. The JAX package's cyclic reduction stops at 8 blocks and
solves those densely (``dense_tail``, a trade of TPU launch latency); the
reduction down to one block here is the same solve.

The single right-hand side (2-D r, or a 3-D r with q = 1) runs the
kernel's q = 1 instance, compiled as it was before multi-column r existed:
a 3-D r with q = 1 gives the 2-D answer's bits.

A Schur complement that is not positive definite gives NaN, in the kernel
and in the plain version alike (as JAX's cyclic reduction does); the
Pallas kernel's unpivoted Gauss-Jordan gave finite values there. The
solver's bad-step branch turns a non-finite step into a zero step.
"""

import torch

from slam_tricks_tpu_torch.ops import _build
from slam_tricks_tpu_torch.ops.spd_solve import _check_out

LAUNCHES = 0    # kernel launches since the last reset (chip_smoke.py reads it)
MAX_M = 512
MAX_Q = 16      # right-hand sides a launch


def tile_values(m, q=1):
    """Values of a block's working tile: the m x m block padded with the
    identity to mp = m rounded up to 32 (the kernel's panels), 2 m + q
    columns carried along, and mp scales."""
    mp = -(-m // 32) * 32
    return mp * (mp + 2 * m + q + 1)


def smem_bytes(m, dtype, q=1):
    """Shared memory the kernel needs to keep a block's tile there."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return tile_values(m, q) * itemsize


def flops(G, m, q=1):
    """Floating-point operations an SPD block-tridiagonal solve needs (block
    Cholesky, not the kernel's cyclic reduction): per block a Cholesky
    factor (m^3 / 3) and, past the first, a triangular solve L^-1 E^T (m^3)
    and the symmetric update D - V^T V (m^3); per block and right-hand side
    ~8 m^2 for the right-hand side, the two triangular solves of each sweep
    and E^T x."""
    return m ** 3 * G // 3 + 2 * m ** 3 * (G - 1) + 8 * m ** 2 * G * q


def _nan_where(info, W):
    bad = (info != 0).reshape(-1, *([1] * (W.dim() - 1)))
    return torch.where(bad, torch.full_like(W, float("nan")), W)


def tridiag_solve_plain(D, E, r):
    """Plain torch version, the kernel's block cyclic reduction level by
    level, batched: at each level the odd rows i give
    W_i = D_i^-1 [E_{i-1} | E_i^T | r_i] (Cholesky), the even rows the
    half-size system; one block is solved by Cholesky; back-substitution
    x_i = M r_i - M E_{i-1} x_{i-1} - M E_i^T x_{i+1}. r (G, m) or
    (G, m, q). A block that is not positive definite gives NaN, as in the
    kernel."""
    if r.dim() == 2:
        return tridiag_solve_plain(D, E, r[..., None])[..., 0]
    m = D.shape[-1]
    levels = []
    Dc, Ec, rc = D, E, r
    while Dc.shape[0] > 1:
        Gc = Dc.shape[0]
        hodd, hev = Gc // 2, (Gc + 1) // 2
        Ea = Ec[0::2][:hodd]                  # E_{i-1} = E_2k
        Eb = torch.zeros_like(Ea)             # E_i = E_2k+1 (0 past the end)
        Eb[:(Gc - 1) // 2] = Ec[1::2]
        rhs = torch.cat([Ea, Eb.transpose(1, 2), rc[1::2]], dim=2)
        L, info = torch.linalg.cholesky_ex(Dc[1::2])
        W = _nan_where(info, torch.cholesky_solve(rhs, L))
        MoEe, MoEoT, Mro = W[..., :m], W[..., m:2 * m], W[..., 2 * m:]
        Dn = Dc[0::2].clone()
        rn = rc[0::2].clone()
        Dn[:hodd] -= Ea.transpose(1, 2) @ MoEe
        rn[:hodd] -= Ea.transpose(1, 2) @ Mro
        Eu = Ec[1::2][:hev - 1]               # E_2k-1 for k >= 1
        Dn[1:] -= Eu @ MoEoT[:hev - 1]
        rn[1:] -= Eu @ Mro[:hev - 1]
        En = -(Eu @ MoEe[:hev - 1])           # -E_2k+1 M E_2k, k < hev - 1
        levels.append((Gc, W))
        Dc, Ec, rc = Dn, En, rn
    L, info = torch.linalg.cholesky_ex(Dc[0])
    x = _nan_where(info[None], torch.cholesky_solve(rc[0], L)[None])
    for Gc, W in reversed(levels):
        hodd = Gc // 2
        xe = x
        xr = torch.zeros_like(xe[:hodd])
        xr[:xe.shape[0] - 1] = xe[1:hodd + 1]
        xo = (W[..., 2 * m:] - W[..., :m] @ xe[:hodd]
              - W[..., m:2 * m] @ xr)
        x = torch.empty((Gc, m, r.shape[-1]), dtype=D.dtype, device=D.device)
        x[0::2] = xe
        x[1::2] = xo
    return x


def _launch(D, E, r, out=None):
    global LAUNCHES
    dtype, device = D.dtype, D.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tridiag_solve kernel takes float32/float64, not {dtype}")
    G, m = r.shape[:2] if r.dim() in (2, 3) else (0, 0)
    q = r.shape[2] if r.dim() == 3 else 1
    shapes = {"D": (G, m, m), "E": (G - 1, m, m), "r": tuple(r.shape[:3])}
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
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"tridiag_solve: q={q} right-hand sides, the "
                         f"kernel takes 1 to {MAX_Q}")
    lib = _build.library()
    hmax = (G + 1) // 2
    # the level store (W_i of every odd row of every level) and the two
    # ping-pong level buffers (D, E, r of the half-size system)
    store = torch.empty(max(G - 1, 1) * m * (2 * m + q), dtype=dtype,
                        device=device)
    lev = torch.empty(2 * hmax * (2 * m * m + m * q), dtype=dtype,
                      device=device)
    if out is not None:
        _check_out(out, r, "tridiag_solve")
    x = torch.empty_like(r) if out is None else out
    work = None                  # tiles in shared memory, else here
    if smem_bytes(m, dtype, q) > _build.SMEM_PER_BLOCK:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        work = torch.empty(min(sms, hmax) * tile_values(m, q), dtype=dtype,
                           device=device)
    fn = lib.tridiag_solve_f32 if dtype == torch.float32 else lib.tridiag_solve_f64
    with torch.cuda.device(device):
        rc = fn(D.data_ptr(), E.data_ptr(), r.data_ptr(), store.data_ptr(),
                lev.data_ptr(), None if work is None else work.data_ptr(),
                x.data_ptr(), G, m, q, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "tridiag_solve")
    LAUNCHES += 1
    return x


def tridiag_solve(D, E, r, out=None):
    """Solve the SPD block-tridiagonal system (D (G, m, m), E (G-1, m, m),
    r (G, m) or (G, m, q)) -> x of r's shape: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. out: a tensor like r that
    takes x (returned), or None."""
    if D.device.type == "cpu":
        x = tridiag_solve_plain(D, E, r)
        if out is None:
            return x
        _check_out(out, r, "tridiag_solve")
        return out.copy_(x)
    if D.device.type != "cuda":
        raise ValueError(f"tridiag_solve: no kernel for device {D.device}")
    return _launch(D, E, r, out)
