"""Linearize + assemble of the slot-major BA normal equations.

One pass over the (K, L) slot grid (slot k of landmark l; padding slots have
weight 0) computes each observation's pinhole residual and its analytic
pose and point Jacobian columns, sqrt-weighted, and reduces them to

- per camera: the 21 upper-triangle terms of JpᵀJp, the 6 of Jpᵀr and
  0.5 w ‖d‖²  -> Hpp (C, 21), gp (C, 6), cost;
- per landmark: the 6 upper-triangle terms of JlᵀJl and the 3 of Jlᵀr
  -> Hll (6, L), gl (3, L);
- per slot: W = JpᵀJl -> (18, K, L), row i*3 + j.

With a robust loss (``residuals/robust.Loss``) each slot's rows are
scaled by sqrt(w · weight(‖d‖²)) and its cost is 0.5 w rho(‖d‖²), the IRLS
form of the JAX package's ``_linearize_sm``; the kernel takes the loss as
its kind and parameter.

With ``intr=`` (C, 3) the camera block is BAL's 9-parameter camera
(``residuals/bal.py``): tangent [omega, dt, df, dk1, dk2], the pixel
residual f (1 + k1 r² + k2 r⁴) x - uv, and per camera the 45 + 9 terms
-> Hpp (C, 45), gp (C, 9), per slot W (27, K, L), in the same layout at
the other width. ``linearize_assemble_grids`` assembles one problem laid
out as several slot-major grids (the track-length buckets of
``solvers/schur_bal.py``) into one Hpp, gp and cost and one (6, L), (3, L)
of landmark sums.

The 6-wide form is ``slam_tricks_tpu/solvers/schur_flat_sm.py::_quantities_sm`` in
another package, and what ``slam_tricks_tpu/ops/pallas_ba.py::_kernel``
(called by ``linearize_assemble``) computes on the TPU in an
observation-sorted layout.

``linearize_assemble`` runs the CUDA kernel ``csrc/ba_assemble.cu`` for CUDA
tensors and the plain torch version ``linearize_assemble_plain`` for CPU
tensors. The kernel takes float32 and float64. It sums the camera side
through a camera-major index of the live slots (``camera_index``, built
once a problem by the solvers' layout builders), in a fixed order and
without float atomics, so it returns the same bits on every launch.
"""

from typing import NamedTuple, Optional

import torch

from slam_tricks_tpu_torch.ops import _build
from slam_tricks_tpu_torch.residuals import robust

LAUNCHES = 0    # kernel runs since the last reset (chip_smoke.py reads it)

# floating-point operations of one live slot of the function, each term
# once: projection 21, residual and cost 11, Jacobians 40, W 54, camera sums
# 109, landmark sums 36 (a padding slot only stores its zero W). The
# kernel's camera pass computes projection, residual and Jacobians a second
# time, which this count leaves out.
FLOPS_PER_SLOT = 271
# a robust loss adds, a live slot: its weight and rho of s (at most 9: the
# Tukey polynomial), w times the weight and 0.5 w rho (3), and the cost's
# ‖d‖² the plain count already has
LOSS_FLOPS_PER_SLOT = 12

# the same at BAL's 9-wide camera block: projection 21, distortion,
# residual and cost 20, Jacobians 82, W 81, camera sums 217 (45 + 9 terms
# and the cost), landmark sums 36
FLOPS_PER_SLOT9 = 457

SEGMENT = 64    # slots of a camera-pass segment: kSeg of the kernel
_INT32_MAX = 2 ** 31 - 1

_IJ6 = [(i, j) for i in range(6) for j in range(i, 6)]     # 21 entries
_IJ3 = [(i, j) for i in range(3) for j in range(i, 3)]     # 6 entries
_IJ9 = [(i, j) for i in range(9) for j in range(i, 9)]     # 45 entries


def _ij(width):
    return _IJ6 if width == 6 else _IJ9


def _weigh(w, d0, d1, loss):
    """(sqrt of the slot's weight, its cost) from the residual d."""
    if loss is None:
        return torch.sqrt(w), 0.5 * w * (d0 * d0 + d1 * d1)
    sqn = d0 * d0 + d1 * d1
    return torch.sqrt(w * loss.weight(sqn)), 0.5 * w * loss.rho(sqn)


def _rotation_columns(jl, px, py, pz):
    """The pose Jacobian's rotation columns of one row from the point's:
    R exp(omega) moves p by -R [X]x omega."""
    return [jl[2] * py - jl[1] * pz, jl[0] * pz - jl[2] * px,
            jl[1] * px - jl[0] * py]


def _linearize_sm(R_flat, t, points, uv0, uv1, w, cam_of_slot, loss=None,
                  intr=None):
    """Slot-major residual rows, camera/point Jacobian columns and cost
    column, each (K, L); with a robust loss, rows and columns are scaled by
    sqrt(w · weight(s)) and the cost is 0.5 w rho(s), s = ‖d‖². intr
    (C, 3): BAL's camera, 9 camera columns, the pixel residual."""
    cam = cam_of_slot.long()
    if intr is not None:
        return _linearize_bal(R_flat, t, intr, points, uv0, uv1, w, cam,
                              loss)
    r_ = R_flat.T[:, cam]                                   # (9, K, L)
    tn = t.T[:, cam]                                        # (3, K, L)
    px, py, pz = points[:, 0][None], points[:, 1][None], points[:, 2][None]
    x = r_[0] * px + r_[1] * py + r_[2] * pz + tn[0]
    y = r_[3] * px + r_[4] * py + r_[5] * pz + tn[1]
    z = r_[6] * px + r_[7] * py + r_[8] * pz + tn[2]
    # a padding slot has camera 0, which may see the point at z <= 0:
    # without the guard, 0 * inf = NaN
    z = torch.where(w > 0, z, torch.ones_like(z))
    iz = 1.0 / z
    u = x * iz
    v = y * iz
    d0 = u - uv0
    d1 = v - uv1
    sw, cost_col = _weigh(w, d0, d1, loss)
    r0 = d0 * sw
    r1 = d1 * sw
    sziz = sw * iz
    jl0 = [(r_[j] - u * r_[6 + j]) * sziz for j in range(3)]
    jl1 = [(r_[3 + j] - v * r_[6 + j]) * sziz for j in range(3)]
    zero = torch.zeros_like(x)
    jp0 = _rotation_columns(jl0, px, py, pz) + [sziz, zero, -u * sziz]
    jp1 = _rotation_columns(jl1, px, py, pz) + [zero, sziz, -v * sziz]
    return (r0, r1), (jp0, jp1), (jl0, jl1), cost_col


def _linearize_bal(R_flat, t, intr, points, uv0, uv1, w, cam, loss):
    """The 9-wide rows of ``_linearize_sm``: uv = f a (u, v), (u, v) =
    p.xy / p.z, a = 1 + k1 r2 + k2 r2², whose derivative in (u, v) is
    s I + g (u, v)(u, v)ᵀ, s = f a, g = 2 f (k1 + 2 k2 r2); the kernel's
    ``linearize9`` term for term. The projection and the residual are
    computed in float64 whatever the dtype, and rounded to it after: a
    residual of a pixel or two is the difference of two numbers of some
    hundreds, which float32 would give to ~1e-5 of itself."""
    dtype = points.dtype
    hi = torch.float64
    r_ = R_flat.T.to(hi)[:, cam]                            # (9, K, L)
    tn = t.T.to(hi)[:, cam]
    kn = intr.T.to(hi)[:, cam]
    ph = points.to(hi)
    px, py, pz = ph[:, 0][None], ph[:, 1][None], ph[:, 2][None]
    x = r_[0] * px + r_[1] * py + r_[2] * pz + tn[0]
    y = r_[3] * px + r_[4] * py + r_[5] * pz + tn[1]
    z = r_[6] * px + r_[7] * py + r_[8] * pz + tn[2]
    z = torch.where(w > 0, z, torch.ones_like(z))
    iz = 1.0 / z
    u = x * iz
    v = y * iz
    f, k1, k2 = kn[0], kn[1], kn[2]
    r2 = u * u + v * v
    a = 1.0 + r2 * (k1 + k2 * r2)
    s = f * a
    d0 = (s * u - uv0).to(dtype)
    d1 = (s * v - uv1).to(dtype)
    r_, iz, u, v, f, k1, k2, r2, a, s = (
        q.to(dtype) for q in (r_, iz, u, v, f, k1, k2, r2, a, s))
    px, py, pz = (q.to(dtype) for q in (px, py, pz))
    sw, cost_col = _weigh(w, d0, d1, loss)
    g = 2.0 * f * (k1 + 2.0 * k2 * r2)
    gu, gv = g * u, g * v
    m00 = (s + gu * u) * sw * iz
    m01 = gu * v * sw * iz
    m11 = (s + gv * v) * sw * iz
    j02 = -(m00 * u + m01 * v)
    j12 = -(m01 * u + m11 * v)
    jl0 = [m00 * r_[j] + m01 * r_[3 + j] + j02 * r_[6 + j] for j in range(3)]
    jl1 = [m01 * r_[j] + m11 * r_[3 + j] + j12 * r_[6 + j] for j in range(3)]
    su, sv = sw * u, sw * v
    fr2 = f * r2
    jp0 = _rotation_columns(jl0, px, py, pz) + [m00, m01, j02, a * su,
                                                  fr2 * su, fr2 * r2 * su]
    jp1 = _rotation_columns(jl1, px, py, pz) + [m01, m11, j12, a * sv,
                                                  fr2 * sv, fr2 * r2 * sv]
    return (d0 * sw, d1 * sw), (jp0, jp1), (jl0, jl1), cost_col


def _dot2(a0, a1, b0, b1):
    return a0 * b0 + a1 * b1


def _camera_columns(jp, r, cost_col):
    """The camera columns of each slot, P(P + 1) / 2 + P + 1 of them (28
    at P = 6, 55 at P = 9): the upper-triangle terms of JpᵀJp, the P of
    Jpᵀr and the cost -> (cols, K, L)."""
    (jp0, jp1), (r0, r1) = jp, r
    P = len(jp0)
    cols = [_dot2(jp0[i], jp1[i], jp0[j], jp1[j]) for (i, j) in _ij(P)]
    cols += [_dot2(jp0[i], jp1[i], r0, r1) for i in range(P)]
    cols += [cost_col]
    return torch.stack(cols, dim=0)


def _split(cam_red, lm_red, W):
    """(C, cols) camera sums and (9, L) landmark sums -> the public
    tuple."""
    P = W.shape[0] // 3
    nh = P * (P + 1) // 2
    return (cam_red[:, :nh], cam_red[:, nh:nh + P], lm_red[:6], lm_red[6:],
            W, cam_red[:, nh + P].sum())


def slot_columns(R_flat, t, points, uv0, uv1, w, cam_of_slot, loss=None,
                 intr=None):
    """Each slot's linearization before any camera sum: (camera columns
    (28, K, L), landmark sums (9, L), W (18, K, L)); with intr (C, 3),
    BAL's camera: (55, K, L), (9, L), (27, K, L). cam_of_slot indexes the
    rows of R_flat, t and intr."""
    (r0, r1), (jp0, jp1), (jl0, jl1), cost_col = _linearize_sm(
        R_flat, t, points, uv0, uv1, w, cam_of_slot, loss, intr)
    if intr is None:
        cols = _camera_columns((jp0, jp1), (r0, r1), cost_col)
    else:
        # the camera side's products and sums in float64, as the kernel's
        hi = [q.to(torch.float64) for q in jp0 + jp1 + [r0, r1, cost_col]]
        cols = _camera_columns((hi[:9], hi[9:18]), (hi[18], hi[19]), hi[20])
    lm_cols = [_dot2(jl0[i], jl1[i], jl0[j], jl1[j]) for (i, j) in _IJ3]
    lm_cols += [_dot2(jl0[i], jl1[i], r0, r1) for i in range(3)]
    lm_red = torch.stack([c.sum(dim=0) for c in lm_cols], dim=0)   # (9, L)
    W = torch.stack([_dot2(jp0[i], jp1[i], jl0[j], jl1[j])
                     for i in range(len(jp0)) for j in range(3)], dim=0)
    return cols, lm_red, W


def linearize_assemble_plain(R_flat, t, points, uv0, uv1, w, cam_of_slot,
                             loss=None, intr=None):
    """Plain torch version of the kernel, on any device and dtype; loss a
    ``residuals.robust.Loss`` or None; intr (C, 3) [f, k1, k2] for BAL's
    camera, or None.

    Returns (Hpp (C, 21), gp (C, 6), Hll (6, L), gl (3, L), W (18, K, L),
    cost ()); with intr, Hpp (C, 45), gp (C, 9) and W (27, K, L), the
    camera sums taken in float64 and rounded to the dtype."""
    C = R_flat.shape[0]
    K, L = w.shape
    cols, lm_red, W = slot_columns(R_flat, t, points, uv0, uv1, w,
                                   cam_of_slot, loss, intr)
    n = cols.shape[0]
    cam_red = torch.zeros((C, n), dtype=cols.dtype, device=points.device)
    cam_red.index_add_(0, cam_of_slot.reshape(-1).long(),
                       cols.reshape(n, K * L).T)
    Hpp, gp, Hll, gl, W, cost = _split(cam_red, lm_red, W)
    dtype = points.dtype
    return Hpp.to(dtype), gp.to(dtype), Hll, gl, W, cost.to(dtype)


class CameraIndex(NamedTuple):
    """Camera-major index of the live slots of one (K, L) slot grid, made by
    ``camera_index``. It holds the grid it indexes: ``linearize_assemble``
    takes it only with those very w and cam_of_slot tensors, unmodified."""
    slots: torch.Tensor      # (n_seg, SEGMENT) int32 slot ids k L + l, -1 pads
    seg_cam: torch.Tensor    # (n_seg,) int32 camera of each segment
    seg_start: torch.Tensor  # (C + 1,) int32: camera c's segments are
    #                          [seg_start[c], seg_start[c + 1])
    grid: tuple              # (w, cam_of_slot, their _version when built)


def camera_index(w, cam_of_slot, n_cams):
    """The live slots (w > 0) of a (K, L) slot grid as slot ids n = k L + l,
    sorted by camera, stably (so by n within a camera), each camera's run
    cut into segments of SEGMENT slots and its last segment padded with -1:
    no segment holds two cameras, and each starts with a live slot.
    seg_cam is each segment's camera. Built with torch on the grid's device;
    the kernel's camera pass runs a warp a segment."""
    if (w.dim() != 2 or cam_of_slot.shape != w.shape
            or cam_of_slot.dtype != torch.int32
            or cam_of_slot.device != w.device or not w.is_contiguous()
            or not cam_of_slot.is_contiguous()):
        raise ValueError(
            f"camera_index: w and cam_of_slot must be contiguous (K, L) "
            f"tensors on one device, cam_of_slot int32; got {w.dtype} "
            f"{tuple(w.shape)} on {w.device}, {cam_of_slot.dtype} "
            f"{tuple(cam_of_slot.shape)} on {cam_of_slot.device}")
    if w.numel() > _INT32_MAX:
        raise ValueError(f"camera_index: {w.numel()} slots overflow int32 ids")
    seg = SEGMENT
    device = w.device
    n = torch.nonzero(w.reshape(-1) > 0).squeeze(1)
    cams, order = torch.sort(cam_of_slot.reshape(-1)[n].long(), stable=True)
    n = n[order]
    if cams.numel() and not 0 <= int(cams[0]) <= int(cams[-1]) < n_cams:
        raise ValueError(f"camera_index: a live slot names a camera outside "
                         f"[0, {n_cams})")
    counts = torch.bincount(cams, minlength=n_cams)
    per_cam = (counts + seg - 1) // seg
    seg_start = torch.zeros(n_cams + 1, dtype=torch.int64, device=device)
    seg_start[1:] = torch.cumsum(per_cam, 0)
    rank = (torch.arange(n.shape[0], device=device)
            - (torch.cumsum(counts, 0) - counts)[cams])
    slots = torch.full((int(seg_start[-1]) * seg,), -1, dtype=torch.int32,
                       device=device)
    slots[seg_start[cams] * seg + rank] = n.to(torch.int32)
    seg_cam = torch.repeat_interleave(
        torch.arange(n_cams, dtype=torch.int32, device=device), per_cam)
    return CameraIndex(slots.view(-1, seg), seg_cam, seg_start.to(torch.int32),
                       (w, cam_of_slot, (w._version, cam_of_slot._version)))


def layout_index(w, cam_of_slot, n_cams):
    """What a layout builder keeps for the kernel: the grid's
    ``camera_index`` on a CUDA device, None on the CPU, where
    ``linearize_assemble`` runs the plain version, which reads none."""
    return None if w.device.type == "cpu" else camera_index(w, cam_of_slot,
                                                           n_cams)


def _check_index(index, w, cam_of_slot, n_cams):
    gw, gcam, versions = index.grid
    if (gw is not w or gcam is not cam_of_slot
            or versions != (w._version, cam_of_slot._version)
            or index.seg_start.shape[0] != n_cams + 1):
        raise ValueError("ba_assemble: cam_index was not built by "
                         "camera_index from these w and cam_of_slot tensors "
                         "and this camera count, or they changed since")


class Grid(NamedTuple):
    """One slot-major grid of a problem, which may be laid out in several:
    its (K, L) arrays, its ``layout_index`` (None on the CPU) and the row
    of `points` where its L landmarks start."""
    uv0: torch.Tensor
    uv1: torch.Tensor
    w: torch.Tensor
    cam_of_slot: torch.Tensor
    cam_index: Optional[CameraIndex]
    l0: int


class AssembleOut(NamedTuple):
    """Outputs for ``linearize_assemble(..., out=)`` and
    ``linearize_assemble_grids(..., out=)``, made by ``assemble_out`` and
    ``grids_out``: every call given them writes into the same memory, so
    that a CUDA graph can read a call's results at fixed addresses."""
    buf: torch.Tensor    # the blocks, then the kernel's scratch
    cost: torch.Tensor   # ()


def _sizes(P, C, L, shapes, n_seg, itemsize):
    """(offsets of gp, Hll, gl, each grid's W and the scratch, total
    length), in elements of itemsize bytes, of the one allocation of a
    call at width P over grids of these (K, L) shapes: the blocks, then the
    scratch that the grids, launched one after another, share. P = 6: the
    camera pass's partials (n_seg, 28), each camera's cost (C,) and the
    camera sums' count of finished blocks, in the dtype; P = 9, 64-byte
    aligned: every camera sum (C, 55) and the largest grid's partials
    (n_seg, 55), both in float64, and the count."""
    o_gp = P * (P + 1) // 2 * C
    o_hll = o_gp + P * C
    o_gl = o_hll + 6 * L
    o_w = [o_gl + 3 * L]
    for K, Lg in shapes:
        o_w.append(o_w[-1] + 3 * P * K * Lg)
    if P == 6:
        o_scratch = o_w[-1]
        return (o_gp, o_hll, o_gl, o_w, o_scratch), (o_scratch + 28 * n_seg
                                                     + C + 1)
    step = 64 // itemsize
    o_scratch = -(-o_w[-1] // step) * step
    return ((o_gp, o_hll, o_gl, o_w, o_scratch),
            o_scratch + 8 // itemsize * 55 * (n_seg + C) + 2)


def _views(buf, P, C, L, shapes, offsets=None):
    """(Hpp (C, P(P + 1)/2), gp (C, P), Hll (6, L), gl (3, L),
    [W (3P, K, L) a grid]): the contiguous views of the blocks in buf, at
    the offsets of ``_sizes`` (computed here where not given)."""
    if offsets is None:
        offsets = _sizes(P, C, L, shapes, 0, buf.element_size())[0]
    o_gp, o_hll, o_gl, o_w, _ = offsets
    nh = P * (P + 1) // 2
    return (buf.as_strided((C, nh), (nh, 1), 0),
            buf.as_strided((C, P), (P, 1), o_gp),
            buf.as_strided((6, L), (L, 1), o_hll),
            buf.as_strided((3, L), (L, 1), o_gl),
            [buf.as_strided((3 * P, K, Lg), (K * Lg, Lg, 1), o)
             for (K, Lg), o in zip(shapes, o_w)])


def _out(P, C, L, shapes, n_seg, like):
    return AssembleOut(
        torch.empty(_sizes(P, C, L, shapes, n_seg, like.element_size())[1],
                    dtype=like.dtype, device=like.device),
        torch.empty((), dtype=like.dtype, device=like.device))


def assemble_out(n_cams, w, cam_index=None):
    """An ``AssembleOut`` for calls on the slot grid of w (K, L) with
    n_cams cameras and the grid's camera index (None on the CPU)."""
    n_seg = 0 if cam_index is None else cam_index.slots.shape[0]
    return _out(6, n_cams, w.shape[1], [tuple(w.shape)], n_seg, w)


def grids_out(n_cams, n_points, grids):
    """An ``AssembleOut`` for ``linearize_assemble_grids`` calls on these
    grids (``Grid``s) of n_cams cameras and n_points landmarks."""
    n_seg = max(0 if g.cam_index is None else g.cam_index.slots.shape[0]
                for g in grids)
    return _out(9, n_cams, n_points, [tuple(g.w.shape) for g in grids],
                n_seg, grids[0].w)


def _check(name, a, dtype, device, shape):
    if (a.dtype != dtype or a.device != device or a.shape != shape
            or not a.is_contiguous()):
        raise ValueError(
            f"ba_assemble: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {a.dtype} {tuple(a.shape)} on "
            f"{a.device}")


def _check_grids(grids, L, dtype, device):
    for g in grids:
        sh = tuple(g.w.shape)
        for name in ("uv0", "uv1", "w"):
            _check(name, getattr(g, name), dtype, device, sh)
        if len(sh) != 2 or not 0 <= g.l0 <= L - sh[1]:
            raise ValueError(f"ba_assemble: a grid of {sh} at landmark "
                             f"{g.l0} does not fit {L} landmarks")


def _launch(P, R_flat, t, intr, points, grids, loss, out=None):
    """The kernel of width P on CUDA tensors, a launch a grid, in order on
    the current stream, each grid after the first adding its camera sums
    and cost to those before (P = 9; P = 6 takes one grid). Each grid's
    camera index is checked against its w and cam_of_slot, which
    camera_index checked with it. out: an ``AssembleOut`` of these grids,
    or None (allocated here). Returns (Hpp, gp, Hll, gl, [W a grid],
    cost)."""
    global LAUNCHES
    dtype, device = points.dtype, points.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ba_assemble kernel takes float32/float64, not {dtype}")
    C, L = R_flat.shape[0], points.shape[0]
    shapes = [tuple(g.w.shape) for g in grids]
    if C < 1 or L < 1 or not shapes or 0 in (n for sh in shapes for n in sh):
        raise ValueError(f"ba_assemble: empty problem C={C} L={L} grids "
                         f"{shapes}")
    if P == 6 and (len(grids) != 1 or shapes[0][1] != L):
        raise ValueError("ba_assemble: the 6-wide kernel takes one grid of "
                         "every landmark")
    _check("R_flat", R_flat, dtype, device, (C, 9))
    _check("t", t, dtype, device, (C, 3))
    if P == 9:
        _check("intr", intr, dtype, device, (C, 3))
    _check("points", points, dtype, device, (L, 3))
    _check_grids(grids, L, dtype, device)
    n_seg = max(g.cam_index.slots.shape[0] for g in grids)
    size = points.element_size()
    offsets, n_buf = _sizes(P, C, L, shapes, n_seg, size)
    # one allocation for the outputs and the scratch, each output a
    # contiguous view of it, and the device switched in C: the host's time
    # a call is most of the kernel's at the headline shapes. The cost has
    # its own, since callers keep it longer than the blocks.
    if out is None:
        out = AssembleOut(torch.empty(n_buf, dtype=dtype, device=device),
                          torch.empty((), dtype=dtype, device=device))
    elif (out.buf.shape != (n_buf,) or out.cost.shape != ()
          or any(a.dtype != dtype or a.device != device for a in out)):
        raise ValueError("ba_assemble: out was not made by assemble_out / "
                         "grids_out for these grids, camera indexes and "
                         "dtype")
    buf, cost = out
    Hpp, gp, Hll, gl, Ws = _views(buf, P, C, L, shapes, offsets)
    scratch = buf.data_ptr() + offsets[4] * size
    lib = _build.library()
    fn = getattr(lib, f"ba_assemble{'' if P == 6 else P}_"
                      f"{'f32' if dtype == torch.float32 else 'f64'}")
    # the loss as (code, its parameter, the parameter squared), the square
    # taken in double as the plain version takes it
    kind, p = (0, 0.0) if loss is None else (robust.KINDS[loss.kind],
                                             float(loss.param))
    stream = torch.cuda.current_stream(device).cuda_stream
    for i, (g, W, (K, Lg)) in enumerate(zip(grids, Ws, shapes)):
        index = g.cam_index
        rc = fn(R_flat.data_ptr(), t.data_ptr(),
                None if intr is None else intr.data_ptr(),
                points.data_ptr() + 3 * g.l0 * size, g.uv0.data_ptr(),
                g.uv1.data_ptr(), g.w.data_ptr(), g.cam_of_slot.data_ptr(),
                index.slots.data_ptr(), index.seg_cam.data_ptr(),
                index.seg_start.data_ptr(), index.slots.shape[0], C, K, Lg,
                L, int(i > 0), kind, p, p * p, Hpp.data_ptr(), gp.data_ptr(),
                Hll.data_ptr() + g.l0 * size, gl.data_ptr() + g.l0 * size,
                W.data_ptr(), cost.data_ptr(), scratch, device.index, stream)
        _build.check(rc, "ba_assemble")
        LAUNCHES += 1
    return Hpp, gp, Hll, gl, Ws, cost


def linearize_assemble(R_flat, t, points, uv0, uv1, w, cam_of_slot,
                       cam_index=None, loss=None, out=None):
    """Linearize + assemble: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.

    R_flat (C, 9), t (C, 3), points (L, 3); uv0, uv1, w (K, L); cam_of_slot
    (K, L) int32; cam_index the ``camera_index`` of this w and cam_of_slot
    (the kernel builds it when it is None; the plain version does not use
    it); loss a ``residuals.robust.Loss`` or None. A live slot that the
    loss gives weight 0 stays in the index and adds exact zeros to the
    sums (and its 0.5 w rho to the cost). out: an ``assemble_out`` of this
    grid and camera index, written in place of new outputs (the plain
    version copies its results there). Returns (Hpp (C, 21), gp (C, 6),
    Hll (6, L), gl (3, L), W (18, K, L), cost ())."""
    robust.check(loss)
    if cam_index is not None:
        _check_index(cam_index, w, cam_of_slot, R_flat.shape[0])
    if points.device.type == "cpu":
        got = linearize_assemble_plain(R_flat, t, points, uv0, uv1, w,
                                       cam_of_slot, loss)
        if out is None:
            return got
        Hpp, gp, Hll, gl, (W,) = _views(out.buf, 6, R_flat.shape[0],
                                        w.shape[1], [tuple(w.shape)])
        dest = (Hpp, gp, Hll, gl, W, out.cost)
        for d, g in zip(dest, got):
            d.copy_(g)
        return dest
    if points.device.type != "cuda":
        raise ValueError(f"ba_assemble: no kernel for device {points.device}")
    if cam_index is None:
        cam_index = camera_index(w, cam_of_slot, R_flat.shape[0])
    Hpp, gp, Hll, gl, (W,), cost = _launch(
        6, R_flat, t, None, points,
        [Grid(uv0, uv1, w, cam_of_slot, cam_index, 0)], loss, out)
    return Hpp, gp, Hll, gl, W, cost


# ---- BAL's 9-wide camera over several slot-major grids ----

def linearize_assemble_grids_plain(R_flat, t, intr, points, grids,
                                   loss=None):
    """``linearize_assemble_grids``' plain version, on any device: a
    ``linearize_assemble_plain`` a grid, the camera sums and the cost added
    grid after grid; the grids must hold the landmarks in order, each
    once."""
    L = points.shape[0]
    _check_grids(grids, L, points.dtype, points.device)
    order = [g.l0 for g in grids]
    if order != sorted(order) or sum(g.w.shape[1] for g in grids) != L:
        raise ValueError("ba_assemble: the plain version takes grids that "
                         "hold the landmarks in order, each once")
    parts = [linearize_assemble_plain(
        R_flat, t, points[g.l0:g.l0 + g.w.shape[1]], g.uv0, g.uv1, g.w,
        g.cam_of_slot, loss, intr) for g in grids]
    Hpp, gp, cost = parts[0][0], parts[0][1], parts[0][5]
    for p in parts[1:]:
        Hpp, gp, cost = Hpp + p[0], gp + p[1], cost + p[5]
    return (Hpp, gp, torch.cat([p[2] for p in parts], dim=1),
            torch.cat([p[3] for p in parts], dim=1), [p[4] for p in parts],
            cost)


def linearize_assemble_grids(R_flat, t, intr, points, grids, loss=None,
                             out=None):
    """Linearize + assemble with BAL's 9-wide camera over the slot-major
    grids of one problem: the CUDA kernel a grid for CUDA tensors, the
    camera sums and the cost added grid after grid, the plain version for
    CPU tensors (``linearize_assemble_grids_plain``), summed in the same
    order.

    R_flat (C, 9), t (C, 3), intr (C, 3) [f, k1, k2], points (L, 3); grids
    a sequence of ``Grid``s, each reading points[l0 : l0 + its L] and
    writing those columns of Hll and gl (each landmark in one grid, on the
    CPU in landmark order); loss a ``residuals.robust.Loss`` or None; out
    a ``grids_out`` of these grids that the kernel writes in place of new
    outputs, or None (the plain version takes none). Returns (Hpp (C, 45),
    gp (C, 9), Hll (6, L), gl (3, L), [W (27, K, L) a grid], cost ())."""
    robust.check(loss)
    device = points.device
    C = R_flat.shape[0]
    if device.type == "cpu":
        if out is not None:
            raise ValueError("ba_assemble: the plain version takes no out")
        return linearize_assemble_grids_plain(R_flat, t, intr, points, grids,
                                              loss)
    if device.type != "cuda":
        raise ValueError(f"ba_assemble: no kernel for device {device}")
    grids = [g if g.cam_index is not None
             else g._replace(cam_index=camera_index(g.w, g.cam_of_slot, C))
             for g in grids]
    for g in grids:
        _check_index(g.cam_index, g.w, g.cam_of_slot, C)
    return _launch(9, R_flat, t, intr, points, grids, loss, out)
