"""Newton undistortion of pixels under the radial-tangential model.

``undistort(px, params, iters)`` maps distorted pixels px (N, 2) to
undistorted ones (N, 2); params are the 9 numbers
(fx, fy, cx, cy, k1, k2, k3, p1, p2). It runs the CUDA kernel
``csrc/undistort.cu`` for CUDA tensors and the plain torch version
``undistort_plain`` for CPU tensors. The kernel replaces
``slam_tricks_tpu/ops/pallas_undistort.py::_undistort_kernel`` (called by
``undistort_points_pallas``): 16-byte vectors of pixels a thread, every
Newton step in registers as fused multiply-adds, no padding, a 64-bit count.
It takes float32 and float64, a contiguous (N, 2) tensor aligned to a pixel;
``residuals/camera.undistort_points_fast`` hands it one.
"""

import torch

from slam_tricks_tpu_torch.ops import _build

LAUNCHES = 0    # kernel launches since the last reset (chip_smoke.py reads it)

# Floating-point operations the function needs: a Newton step takes 62 (the
# products of constants such as 2 p1 or 3 k3 worked out once a call, u^2,
# v^2, u v and their doubles once a step, the division counted as one);
# normalizing and going back to pixels take 8 a pixel.
FLOPS_PER_STEP = 62
FLOPS_PER_PIXEL = 8


def undistort_plain(px, params, iters=5):
    """Plain torch version: the same elementwise Newton iteration."""
    fx, fy, cx, cy, k1, k2, k3, p1, p2 = (
        torch.tensor(float(v), dtype=px.dtype, device=px.device) for v in params)
    u0 = (px[:, 0] - cx) / fx
    v0 = (px[:, 1] - cy) / fy
    u, v = u0, v0
    for _ in range(iters):
        r2 = u * u + v * v
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dr = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
        ud = u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
        vd = v * radial + p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v
        fu = ud - u0
        fv = vd - v0
        a = radial + 2.0 * u * u * dr + 2.0 * p1 * v + 6.0 * p2 * u
        b = 2.0 * u * v * dr + 2.0 * p1 * u + 2.0 * p2 * v
        d = radial + 2.0 * v * v * dr + 6.0 * p1 * v + 2.0 * p2 * u
        inv_det = 1.0 / (a * d - b * b)
        u = u - inv_det * (d * fu - b * fv)
        v = v - inv_det * (a * fv - b * fu)
    return torch.stack([fx * u + cx, fy * v + cy], dim=1)


def _launch(px, params, iters):
    global LAUNCHES
    dtype = px.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"undistort kernel takes float32/float64, not {dtype}")
    if (px.dim() != 2 or px.shape[1] != 2 or not px.is_contiguous()
            or px.data_ptr() % (2 * px.element_size())):
        raise ValueError(f"undistort: px must be a contiguous (N, 2) tensor "
                         f"aligned to a pixel; got {tuple(px.shape)}")
    if len(params) != 9 or not 0 <= iters < 2 ** 31:
        raise ValueError("undistort: 9 camera parameters and 0 <= iters < "
                         "2**31")
    n = px.shape[0]
    out = torch.empty_like(px)
    if n == 0:
        return out
    lib = _build.library()
    fn = lib.undistort_f32 if dtype == torch.float32 else lib.undistort_f64
    # n crosses as a 64-bit integer; the device is switched in C
    rc = fn(px.data_ptr(), out.data_ptr(), n, *(float(v) for v in params),
            int(iters), px.device.index,
            torch.cuda.current_stream(px.device).cuda_stream)
    _build.check(rc, "undistort")
    LAUNCHES += 1
    return out


def undistort(px, params, iters=5):
    """(N, 2) distorted pixels -> (N, 2) undistorted: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if px.device.type == "cpu":
        return undistort_plain(px, params, iters)
    if px.device.type != "cuda":
        raise ValueError(f"undistort: no kernel for device {px.device}")
    return _launch(px, params, iters)
