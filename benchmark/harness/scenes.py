"""The benchmark's scenes and starting points, frozen here so that the
yardstick does not move when the program's own simulator does.

Each scene family is a generator of its own, ``scenes/<kind>.py`` (its
``make``), found by the ``kind`` a configuration names; what they share is
here. Observations come back unpadded and in float64; ``padded`` adds the
weight-0 entries that the program's layouts expect.

Starts are drawn on the device from a seed: every pose is moved by the
right perturbation T exp(xi), xi = [rho, omega] ~ N(0, trans^2) x
N(0, rot^2), and every point by N(0, point^2); the fixed cameras keep
their true value.
"""

import importlib
from typing import NamedTuple

import numpy as np
import torch


class Scene(NamedTuple):
    R: np.ndarray        # (C, 3, 3) true world-to-camera rotations
    t: np.ndarray        # (C, 3)
    points: np.ndarray   # (L, 3) true landmarks
    cam: np.ndarray      # (N,) int64
    lm: np.ndarray       # (N,) int64
    uv: np.ndarray       # (N, 2) normalized-plane measurements
    w: np.ndarray        # (N,) weights, 0 for an observation that counts not

    @property
    def n_cams(self):
        return self.R.shape[0]

    @property
    def n_points(self):
        return self.points.shape[0]


def load(folder, name):
    """The module ``benchmark/<folder>/<name>.py`` (a scene family, a traffic
    kind, a solver adapter), by the name a file of the benchmark gives."""
    return importlib.import_module(f"benchmark.{folder}.{name}")


def look_at(eye, target, up=np.array([0.0, 0.0, 1.0])):
    """(R_cw, t_cw) of a camera at `eye` looking at `target`, z forward."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    nx = np.linalg.norm(x)
    x = np.array([1.0, 0, 0]) if nx < 1e-8 else x / nx
    y = np.cross(z, x)
    R_cw = np.stack([x, y, z], axis=1).T
    return R_cw, -R_cw @ eye


def make_scene(spec):
    """The scene a configuration's ``scene`` block names: its ``kind``, the
    generator ``scenes/<kind>.py``, and that generator's keyword
    arguments."""
    spec = dict(spec)
    return load("scenes", spec.pop("kind")).make(**spec)


def padded(scene: Scene, multiple=8):
    """(cam, lm, uv, w) with weight-0 entries (camera 0, landmark 0) added up
    to a multiple of `multiple`, as the program's scene arrays are."""
    pad = (-scene.cam.shape[0]) % multiple
    zi = np.zeros(pad, np.int64)
    return (np.concatenate([scene.cam, zi]), np.concatenate([scene.lm, zi]),
            np.concatenate([scene.uv, np.zeros((pad, 2))]),
            np.concatenate([scene.w, np.zeros(pad)]))


def fixed_mask(n_cams, which):
    """The gauge: "first_last" fixes cameras 0 and C - 1, "first" camera 0."""
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    if which == "first_last":
        fixed[-1] = True
    elif which != "first":
        raise ValueError(f"unknown gauge {which!r}")
    return fixed


def stream_seed(seed, *stream):
    """A 63-bit seed for one stream of draws (a solve, the sample) of a run."""
    ss = np.random.SeedSequence([int(x) % 2 ** 64 for x in (seed, *stream)])
    return int(ss.generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp_and_jl(w):
    """exp(hat w) and the left Jacobian Jl(w) (float64, series below 1e-4)."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th2 / 6, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    c = torch.where(small, 1.0 / 6 - th2 / 120,
                    (ths - torch.sin(ths)) / ths ** 3)
    K = _hat(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a * K + b * K2, eye + b * K + c * K2


def perturbed_start(R, t, points, fixed, levels, seed, cam_rows=None,
                    point_rows=None):
    """A start drawn from `seed` on the device of R (float64 tensors in,
    float64 out): poses moved by T exp(xi), points by normal noise, the
    fixed cameras (bool tensor) unmoved. cam_rows / point_rows (bool
    tensors), where given, restrict the draw to those rows; the others keep
    the values passed in."""
    gen = torch.Generator(device=R.device).manual_seed(seed)
    C, L = R.shape[0], points.shape[0]
    kw = dict(generator=gen, dtype=R.dtype, device=R.device)
    rho = torch.randn(C, 3, **kw) * levels["trans"]
    omg = torch.randn(C, 3, **kw) * levels["rot"]
    noise = torch.randn(L, 3, **kw) * levels["point"]
    move = ~fixed if cam_rows is None else (~fixed) & cam_rows
    rho = rho * move[:, None]
    omg = omg * move[:, None]
    E, Jl = so3_exp_and_jl(omg)
    R1 = R @ E
    t1 = t + (R @ (Jl @ rho[..., None]))[..., 0]
    if point_rows is not None:
        noise = noise * point_rows[:, None]
    return R1, t1, points + noise
