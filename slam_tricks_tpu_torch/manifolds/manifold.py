"""The manifold interface of the solvers: a tangent dimension with a
retraction x [+] delta and its inverse y [-] x.

Port of ``slam_tricks_tpu/manifolds/manifold.py``. Every retract and local
here takes batched arguments as the group modules do: tangents (..., dim)
against points with the same leading dims, so ``batched`` reshapes where
the JAX package maps with ``vmap``.

- ``euclidean(shape)``      plain vector blocks (delta added)
- ``lie(module)``           a group module exposing retract / local / DIM
- ``so3_r3()``              SO(3) (+) R^3 on an ``se3.SE3`` pair
- ``product(m1, m2, ...)``  a tuple of blocks, tangents concatenated
- ``batched(m, n)``         n independent copies along a leading axis
"""

import dataclasses
import math
from typing import Any, Callable

import torch

from slam_tricks_tpu_torch.manifolds import se3, so3


@dataclasses.dataclass(frozen=True)
class Manifold:
    dim: int
    retract: Callable[[Any, torch.Tensor], Any]   # (x, delta (..., dim))
    local: Callable[[Any, Any], torch.Tensor]     # (x, y) -> (..., dim)


def euclidean(shape):
    """Blocks of `shape` (an int or a tuple); points (..., *shape),
    tangents (..., size)."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (int(shape),)
    size = math.prod(shape)

    def retract(x, d):
        return x + d.reshape(*d.shape[:-1], *shape).to(x.dtype)

    def local(x, y):
        diff = y - x
        return diff.reshape(*diff.shape[:diff.dim() - len(shape)], size)

    return Manifold(size, retract, local)


def lie(module):
    """A group module (so2 / se2 / so3 / se3 / sim3) as a Manifold."""
    return Manifold(module.DIM, module.retract, module.local)


def so3_r3():
    """SO(3) (+) R^3, the g2o VertexCamera oplus: the rotation retracts on
    the group, the translation adds; tangent [omega (3), dt (3)]."""

    def retract(T, d):
        return se3.SE3(so3.retract(T.R, d[..., :3]), T.t + d[..., 3:])

    def local(Ta, Tb):
        return torch.cat([so3.local(Ta.R, Tb.R), Tb.t - Ta.t], dim=-1)

    return Manifold(6, retract, local)


def product(*manifolds):
    offsets = [0]
    for m in manifolds:
        offsets.append(offsets[-1] + m.dim)

    def retract(xs, d):
        return tuple(m.retract(x, d[..., offsets[i]:offsets[i + 1]])
                     for i, (m, x) in enumerate(zip(manifolds, xs)))

    def local(xs, ys):
        return torch.cat([m.local(x, y)
                          for m, x, y in zip(manifolds, xs, ys)], dim=-1)

    return Manifold(offsets[-1], retract, local)


def batched(m, n):
    """n independent copies of `m` stacked along a leading axis; the tangent
    is the flat concatenation (n * m.dim,)."""

    def retract(x, d):
        return m.retract(x, d.reshape(n, m.dim))

    def local(x, y):
        return m.local(x, y).reshape(n * m.dim)

    return Manifold(n * m.dim, retract, local)
