"""Linearize + assemble of the slot-major BA normal equations.

One pass over the (K, L) slot grid (slot k of landmark l; padding slots have
weight 0) computes each observation's pinhole residual and its analytic
pose and point Jacobian columns, sqrt-weighted, and reduces them to

- per camera: the 21 upper-triangle terms of JpᵀJp, the 6 of Jpᵀr and
  0.5 w ‖d‖²  -> Hpp (C, 21), gp (C, 6), cost;
- per landmark: the 6 upper-triangle terms of JlᵀJl and the 3 of Jlᵀr
  -> Hll (6, L), gl (3, L);
- per slot: W = JpᵀJl -> (18, K, L), row i*3 + j.

This is ``slam_tricks_tpu/solvers/schur_flat_sm.py::_quantities_sm`` in
another package, and what ``slam_tricks_tpu/ops/pallas_ba.py::_kernel``
(called by ``linearize_assemble``) computes on the TPU in an
observation-sorted layout.

``linearize_assemble`` runs the CUDA kernel ``csrc/ba_assemble.cu`` for CUDA
tensors and the plain torch version ``linearize_assemble_plain`` for CPU
tensors. The kernel takes float32 and float64.
"""

import torch

from slam_tricks_tpu_torch.ops import _build

LAUNCHES = 0    # kernel launches since the last reset (chip_smoke.py reads it)

# floating-point operations of one live slot in the kernel, as written:
# projection 21, residual and cost 11, Jacobians 40, W 54, camera sums 109,
# landmark sums 36 (a padding slot only stores its zero W)
FLOPS_PER_SLOT = 271

_IJ6 = [(i, j) for i in range(6) for j in range(i, 6)]     # 21 entries
_IJ3 = [(i, j) for i in range(3) for j in range(i, 3)]     # 6 entries


def _linearize_sm(R_flat, t, points, uv0, uv1, w, cam_of_slot):
    """Slot-major residual rows, pose/point Jacobian columns and cost column,
    each (K, L)."""
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
    sw = torch.sqrt(w)
    cost_col = 0.5 * w * (d0 * d0 + d1 * d1)
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


def _split(cam_red, lm_red, W):
    """(C, 28) camera sums and (9, L) landmark sums -> the public tuple."""
    return (cam_red[:, :21], cam_red[:, 21:27], lm_red[:6], lm_red[6:], W,
            cam_red[:, 27].sum())


def linearize_assemble_plain(R_flat, t, points, uv0, uv1, w, cam_of_slot):
    """Plain torch version of the kernel, on any device and dtype.

    Returns (Hpp (C, 21), gp (C, 6), Hll (6, L), gl (3, L), W (18, K, L),
    cost ())."""
    C = R_flat.shape[0]
    K, L = w.shape
    (r0, r1), (jp0, jp1), (jl0, jl1), cost_col = _linearize_sm(
        R_flat, t, points, uv0, uv1, w, cam_of_slot)
    cols = [_dot2(jp0[i], jp1[i], jp0[j], jp1[j]) for (i, j) in _IJ6]
    cols += [_dot2(jp0[i], jp1[i], r0, r1) for i in range(6)]
    cols += [cost_col]
    stack = torch.stack(cols, dim=0).reshape(28, K * L)
    cam_red = torch.zeros((C, 28), dtype=points.dtype, device=points.device)
    cam_red.index_add_(0, cam_of_slot.reshape(-1).long(), stack.T)
    lm_cols = [_dot2(jl0[i], jl1[i], jl0[j], jl1[j]) for (i, j) in _IJ3]
    lm_cols += [_dot2(jl0[i], jl1[i], r0, r1) for i in range(3)]
    lm_red = torch.stack([c.sum(dim=0) for c in lm_cols], dim=0)   # (9, L)
    W = torch.stack([_dot2(jp0[i], jp1[i], jl0[j], jl1[j])
                     for i in range(6) for j in range(3)], dim=0)
    return _split(cam_red, lm_red, W)


def _launch(R_flat, t, points, uv0, uv1, w, cam_of_slot):
    global LAUNCHES
    dtype, device = points.dtype, points.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ba_assemble kernel takes float32/float64, not {dtype}")
    C = R_flat.shape[0]
    K, L = w.shape
    shapes = {"R_flat": (C, 9), "t": (C, 3), "points": (L, 3), "uv0": (K, L),
              "uv1": (K, L), "w": (K, L), "cam_of_slot": (K, L)}
    args = {"R_flat": R_flat, "t": t, "points": points, "uv0": uv0,
            "uv1": uv1, "w": w, "cam_of_slot": cam_of_slot}
    for name, a in args.items():
        want = torch.int32 if name == "cam_of_slot" else dtype
        if (a.device != device or a.dtype != want
                or tuple(a.shape) != shapes[name] or not a.is_contiguous()):
            raise ValueError(
                f"ba_assemble: {name} must be a contiguous {want} tensor of "
                f"shape {shapes[name]} on {device}; got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    if C < 1 or K < 1 or L < 1:
        raise ValueError(f"ba_assemble: empty problem C={C} K={K} L={L}")
    smem = C * 12 * points.element_size()      # the camera rows (R, t)
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(
            f"ba_assemble: C={C} cameras need {smem} B of shared memory, "
            f"more than a block's {_build.SMEM_PER_BLOCK} B")
    lib = _build.library()
    cam_red = torch.zeros((C, 28), dtype=dtype, device=device)
    lm_red = torch.empty((9, L), dtype=dtype, device=device)
    W = torch.empty((18, K, L), dtype=dtype, device=device)
    fn = lib.ba_assemble_f32 if dtype == torch.float32 else lib.ba_assemble_f64
    with torch.cuda.device(device):
        rc = fn(R_flat.data_ptr(), t.data_ptr(), points.data_ptr(),
                uv0.data_ptr(), uv1.data_ptr(), w.data_ptr(),
                cam_of_slot.data_ptr(), C, K, L, cam_red.data_ptr(),
                lm_red.data_ptr(), W.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "ba_assemble")
    LAUNCHES += 1
    return _split(cam_red, lm_red, W)


def linearize_assemble(R_flat, t, points, uv0, uv1, w, cam_of_slot):
    """Linearize + assemble: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.

    R_flat (C, 9), t (C, 3), points (L, 3); uv0, uv1, w (K, L); cam_of_slot
    (K, L) int32. Returns (Hpp (C, 21), gp (C, 6), Hll (6, L), gl (3, L),
    W (18, K, L), cost ())."""
    if points.device.type == "cpu":
        return linearize_assemble_plain(R_flat, t, points, uv0, uv1, w,
                                        cam_of_slot)
    if points.device.type != "cuda":
        raise ValueError(f"ba_assemble: no kernel for device {points.device}")
    return _launch(R_flat, t, points, uv0, uv1, w, cam_of_slot)
