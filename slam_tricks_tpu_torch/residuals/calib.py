"""The Zhang-calibration refinement residual, pixel = K distort(
normalize(T_cw [X, Y, 0])) (port of ``slam_tricks_tpu/residuals/calib.py``;
st3-calibration calib.cpp:282-422): 4 intrinsics, 5 distortion
coefficients and a pose a view.
"""

import torch

from slam_tricks_tpu_torch.manifolds import se3
from slam_tricks_tpu_torch.residuals import camera


def calib_residual(intr, dist, T_cw, board_point, pixel):
    """The pixel residual (..., 2) of board corners (..., 2) on the Z = 0
    model plane (calib.cpp:31-35) seen by views T_cw at pixels (..., 2);
    T_cw broadcasts against the corners' leading dims."""
    p_world = torch.cat([board_point, torch.zeros_like(board_point[..., :1])],
                        dim=-1)
    p_norm = camera.perspective_divide(se3.act(T_cw, p_world))
    return camera.project(intr, camera.distort_normalized(dist, p_norm)) \
        - pixel


def pack_intrinsics(intr, dist):
    """(intr, dist) -> the 9-vector [fx, fy, cx, cy, k1, k2, k3, p1, p2],
    in the dtype and on the device of the first tensor among them (numbers
    such as ``DistCoeffs.zeros()``'s follow it)."""
    vals = (*intr, *dist)
    ref = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    kw = {} if ref is None else {"dtype": ref.dtype, "device": ref.device}
    return torch.stack([torch.as_tensor(v, **kw) for v in vals])


def unpack_intrinsics(v):
    return (camera.Intrinsics(v[0], v[1], v[2], v[3]),
            camera.DistCoeffs(v[4], v[5], v[6], v[7], v[8]))
