"""The port's cube-room scene (slam_tricks_tpu_torch/sim/ba_scene.py) against
the JAX package's: the numpy core is shared line for line, so the
observations come out bit-identical; the perturbed poses go through each
package's own se3.retract, so they agree to 1e-12 in f64 and 1e-6 in f32."""

import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import perturb_scene as jperturb_scene
from slam_tricks_tpu_torch.sim import make_scene, perturb_scene
import tests.torch_util  # noqa: F401  (caps torch's threads)

_TDT = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pix_noise", [0.0, 1e-3])
def test_make_scene_bit_identical(dtype, pix_noise):
    kw = dict(n_per_wall=60, n_cams=16, seed=3, pix_noise=pix_noise)
    ref = jmake_scene(dtype=dtype, **kw)
    out = make_scene(dtype=_TDT[dtype], device="cpu", **kw)
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


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_perturb_scene_matches(dtype, tol):
    kw = dict(n_per_wall=60, n_cams=16, seed=3)
    ref_p, ref_x, ref_f = jperturb_scene(jmake_scene(dtype=dtype, **kw), seed=4)
    out_p, out_x, out_f = perturb_scene(make_scene(dtype=_TDT[dtype], device="cpu",
                                                   **kw),
                                        seed=4)
    np.testing.assert_allclose(out_p.R.numpy(), np.asarray(ref_p.R),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(out_p.t.numpy(), np.asarray(ref_p.t),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x),
                               rtol=0, atol=tol)
    np.testing.assert_array_equal(out_f.numpy(), np.asarray(ref_f))
