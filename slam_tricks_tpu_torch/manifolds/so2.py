"""SO(2) as an angle theta (...), batched over any leading dimensions.

Port of ``slam_tricks_tpu/manifolds/so2.py``: tangents are (..., 1),
angles are wrapped to (-pi, pi] by every group operation.
"""

import torch

from slam_tricks_tpu_torch.device import resolve

DIM = 1


def identity(dtype=torch.float32, device=None):
    return torch.zeros((), dtype=dtype, device=resolve(device))


def exp(w):
    """Tangent (..., 1) -> angle (...)."""
    return w[..., 0]


def log(theta):
    return wrap(theta)[..., None]


def wrap(theta):
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def matrix(theta):
    """(..., 2, 2) rotation matrix."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def mul(a, b):
    return wrap(a + b)


def inv(theta):
    return -theta


def act(theta, p):
    """Rotate points p (..., 2); theta broadcasts against p's leading
    dims."""
    return (matrix(theta) @ p[..., None])[..., 0]


def retract(theta, w):
    return wrap(theta + w[..., 0])


def local(a, b):
    return wrap(b - a)[..., None]
