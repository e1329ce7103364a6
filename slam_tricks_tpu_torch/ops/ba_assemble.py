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

This is ``slam_tricks_tpu/solvers/schur_flat_sm.py::_quantities_sm`` in
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

from typing import NamedTuple

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

SEGMENT = 64    # slots of a camera-pass segment: kSeg of the kernel
_INT32_MAX = 2 ** 31 - 1

_IJ6 = [(i, j) for i in range(6) for j in range(i, 6)]     # 21 entries
_IJ3 = [(i, j) for i in range(3) for j in range(i, 3)]     # 6 entries


def _linearize_sm(R_flat, t, points, uv0, uv1, w, cam_of_slot, loss=None):
    """Slot-major residual rows, pose/point Jacobian columns and cost column,
    each (K, L); with a robust loss, rows and columns are scaled by
    sqrt(w · weight(s)) and the cost is 0.5 w rho(s), s = ‖d‖²."""
    cam = cam_of_slot.long()
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
    if loss is None:
        sw = torch.sqrt(w)
        cost_col = 0.5 * w * (d0 * d0 + d1 * d1)
    else:
        sqn = d0 * d0 + d1 * d1
        sw = torch.sqrt(w * loss.weight(sqn))
        cost_col = 0.5 * w * loss.rho(sqn)
    r0 = d0 * sw
    r1 = d1 * sw
    sziz = sw * iz
    jl0 = [(r_[j] - u * r_[6 + j]) * sziz for j in range(3)]
    jl1 = [(r_[3 + j] - v * r_[6 + j]) * sziz for j in range(3)]
    jo0 = [jl0[2] * py - jl0[1] * pz,
           jl0[0] * pz - jl0[2] * px,
           jl0[1] * px - jl0[0] * py]
    jo1 = [jl1[2] * py - jl1[1] * pz,
           jl1[0] * pz - jl1[2] * px,
           jl1[1] * px - jl1[0] * py]
    zero = torch.zeros_like(x)
    jp0 = jo0 + [sziz, zero, -u * sziz]
    jp1 = jo1 + [zero, sziz, -v * sziz]
    return (r0, r1), (jp0, jp1), (jl0, jl1), cost_col


def _dot2(a0, a1, b0, b1):
    return a0 * b0 + a1 * b1


def _camera_columns(jp, r, cost_col):
    """The 28 camera columns of each slot: the 21 upper-triangle terms of
    JpᵀJp, the 6 of Jpᵀr and the cost -> (28, K, L)."""
    (jp0, jp1), (r0, r1) = jp, r
    cols = [_dot2(jp0[i], jp1[i], jp0[j], jp1[j]) for (i, j) in _IJ6]
    cols += [_dot2(jp0[i], jp1[i], r0, r1) for i in range(6)]
    cols += [cost_col]
    return torch.stack(cols, dim=0)


def _split(cam_red, lm_red, W):
    """(C, 28) camera sums and (9, L) landmark sums -> the public tuple."""
    return (cam_red[:, :21], cam_red[:, 21:27], lm_red[:6], lm_red[6:], W,
            cam_red[:, 27].sum())


def slot_columns(R_flat, t, points, uv0, uv1, w, cam_of_slot, loss=None):
    """Each slot's linearization before any camera sum: (camera columns
    (28, K, L), landmark sums (9, L), W (18, K, L)). cam_of_slot indexes
    the rows of R_flat and t."""
    (r0, r1), (jp0, jp1), (jl0, jl1), cost_col = _linearize_sm(
        R_flat, t, points, uv0, uv1, w, cam_of_slot, loss)
    cols = _camera_columns((jp0, jp1), (r0, r1), cost_col)
    lm_cols = [_dot2(jl0[i], jl1[i], jl0[j], jl1[j]) for (i, j) in _IJ3]
    lm_cols += [_dot2(jl0[i], jl1[i], r0, r1) for i in range(3)]
    lm_red = torch.stack([c.sum(dim=0) for c in lm_cols], dim=0)   # (9, L)
    W = torch.stack([_dot2(jp0[i], jp1[i], jl0[j], jl1[j])
                     for i in range(6) for j in range(3)], dim=0)
    return cols, lm_red, W


def linearize_assemble_plain(R_flat, t, points, uv0, uv1, w, cam_of_slot,
                             loss=None):
    """Plain torch version of the kernel, on any device and dtype; loss a
    ``residuals.robust.Loss`` or None.

    Returns (Hpp (C, 21), gp (C, 6), Hll (6, L), gl (3, L), W (18, K, L),
    cost ())."""
    C = R_flat.shape[0]
    K, L = w.shape
    cols, lm_red, W = slot_columns(R_flat, t, points, uv0, uv1, w,
                                   cam_of_slot, loss)
    cam_red = torch.zeros((C, 28), dtype=points.dtype, device=points.device)
    cam_red.index_add_(0, cam_of_slot.reshape(-1).long(),
                       cols.reshape(28, K * L).T)
    return _split(cam_red, lm_red, W)


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


class AssembleOut(NamedTuple):
    """Outputs for ``linearize_assemble(..., out=)``, made by
    ``assemble_out``: every call given them writes into the same memory, so
    that a CUDA graph can read a call's results at fixed addresses."""
    buf: torch.Tensor    # the blocks, then the kernel's scratch
    cost: torch.Tensor   # ()


def _sizes(C, K, L, n_seg):
    """(offsets of gp, Hll, gl, W and the scratch, total length) of the one
    allocation of a call: the blocks, the camera pass's partials (n_seg,
    28), each camera's cost (C,) and the camera sums' count of finished
    blocks."""
    o_gp = 21 * C
    o_hll = o_gp + 6 * C
    o_gl = o_hll + 6 * L
    o_w = o_gl + 3 * L
    o_scratch = o_w + 18 * K * L
    return (o_gp, o_hll, o_gl, o_w, o_scratch), o_scratch + 28 * n_seg + C + 1


def _views(buf, C, K, L):
    """(Hpp (C, 21), gp (C, 6), Hll (6, L), gl (3, L), W (18, K, L)): the
    contiguous views of the blocks in buf."""
    (o_gp, o_hll, o_gl, o_w, _), _ = _sizes(C, K, L, 0)
    return (buf.as_strided((C, 21), (21, 1), 0),
            buf.as_strided((C, 6), (6, 1), o_gp),
            buf.as_strided((6, L), (L, 1), o_hll),
            buf.as_strided((3, L), (L, 1), o_gl),
            buf.as_strided((18, K, L), (K * L, L, 1), o_w))


def assemble_out(n_cams, w, cam_index=None):
    """An ``AssembleOut`` for calls on the slot grid of w (K, L) with
    n_cams cameras and the grid's camera index (None on the CPU)."""
    K, L = w.shape
    n_seg = 0 if cam_index is None else cam_index.slots.shape[0]
    return AssembleOut(
        torch.empty(_sizes(n_cams, K, L, n_seg)[1], dtype=w.dtype,
                    device=w.device),
        torch.empty((), dtype=w.dtype, device=w.device))


def _launch(R_flat, t, points, uv0, uv1, w, cam_of_slot, index, loss,
            out=None):
    """The kernel on CUDA tensors; index is checked against w and
    cam_of_slot, which camera_index checked with it. out: an
    ``AssembleOut`` of this grid, or None (allocated here)."""
    global LAUNCHES
    dtype, device = points.dtype, points.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ba_assemble kernel takes float32/float64, not {dtype}")
    C = R_flat.shape[0]
    K, L = w.shape
    if C < 1 or K < 1 or L < 1:
        raise ValueError(f"ba_assemble: empty problem C={C} K={K} L={L}")
    for name, a, shape in (("R_flat", R_flat, (C, 9)), ("t", t, (C, 3)),
                           ("points", points, (L, 3)), ("uv0", uv0, (K, L)),
                           ("uv1", uv1, (K, L)), ("w", w, (K, L))):
        if (a.dtype != dtype or a.device != device or a.shape != shape
                or not a.is_contiguous()):
            raise ValueError(
                f"ba_assemble: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {device}; got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    n_seg = index.slots.shape[0]
    lib = _build.library()
    # one allocation for the outputs and the scratch, each output a
    # contiguous view of it, and the device switched in C: the host's time
    # a call is most of the kernel's at the headline shapes. The cost has
    # its own, since callers keep it longer than the blocks.
    (_, _, _, _, o_scratch), n_buf = _sizes(C, K, L, n_seg)
    if out is None:
        out = AssembleOut(torch.empty(n_buf, dtype=dtype, device=device),
                          torch.empty((), dtype=dtype, device=device))
    elif (out.buf.shape != (n_buf,) or out.cost.shape != ()
          or any(a.dtype != dtype or a.device != device
                 for a in out)):
        raise ValueError("ba_assemble: out was not made by assemble_out for "
                         "this grid, camera index and dtype")
    buf, cost = out
    Hpp, gp, Hll, gl, W = _views(buf, C, K, L)
    fn = lib.ba_assemble_f32 if dtype == torch.float32 else lib.ba_assemble_f64
    # the loss as (code, its parameter, the parameter squared), the square
    # taken in double as the plain version takes it
    kind, p = (0, 0.0) if loss is None else (robust.KINDS[loss.kind],
                                             float(loss.param))
    rc = fn(R_flat.data_ptr(), t.data_ptr(), points.data_ptr(),
            uv0.data_ptr(), uv1.data_ptr(), w.data_ptr(),
            cam_of_slot.data_ptr(), index.slots.data_ptr(),
            index.seg_cam.data_ptr(), index.seg_start.data_ptr(), n_seg, C, K,
            L, kind, p, p * p, Hpp.data_ptr(), gp.data_ptr(), Hll.data_ptr(), gl.data_ptr(),
            W.data_ptr(), cost.data_ptr(),
            buf.data_ptr() + o_scratch * buf.element_size(), device.index,
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "ba_assemble")
    LAUNCHES += 1
    return Hpp, gp, Hll, gl, W, cost


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
        dest = _views(out.buf, R_flat.shape[0], *w.shape) + (out.cost,)
        for d, g in zip(dest, got):
            d.copy_(g)
        return dest
    if points.device.type != "cuda":
        raise ValueError(f"ba_assemble: no kernel for device {points.device}")
    if cam_index is None:
        cam_index = camera_index(w, cam_of_slot, R_flat.shape[0])
    return _launch(R_flat, t, points, uv0, uv1, w, cam_of_slot, cam_index,
                   loss, out)
