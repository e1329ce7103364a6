"""The port's trajectory scene (slam_tricks_tpu_torch/sim/ba_scene.py::
make_trajectory_scene) against the JAX package's: the numpy core is the
same, so observations, poses and points are bit-identical for the same
arguments, in f32 and f64."""

import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.sim import make_trajectory_scene
import tests.torch_util  # noqa: F401  (caps torch's threads)

_TDT = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pix_noise", [0.0, 1e-3])
def test_bit_identical(dtype, pix_noise):
    kw = dict(n_cams=32, n_points=600, track_len=6, seed=71,
              pix_noise=pix_noise)
    ref = jmake_trajectory(dtype=dtype, **kw)
    out = make_trajectory_scene(dtype=_TDT[dtype], device="cpu", **kw)
    assert (out.n_cams, out.n_points) == (ref.n_cams, ref.n_points)
    for name in ("cam_idx", "lm_idx", "uv", "weight"):
        a, b = getattr(out.obs, name).numpy(), np.asarray(getattr(ref.obs, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(out.poses_true.R.numpy(),
                                  np.asarray(ref.poses_true.R))
    np.testing.assert_array_equal(out.poses_true.t.numpy(),
                                  np.asarray(ref.poses_true.t))
    np.testing.assert_array_equal(out.points_true.numpy(),
                                  np.asarray(ref.points_true))


def test_entry_points_default_to_the_card():
    assert resolve(None) == torch.device("cuda")
    assert resolve("cpu") == torch.device("cpu")
