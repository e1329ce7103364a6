"""The port's vi_smoother_demo and kitti_vo_demo
(slam_tricks_tpu_torch.examples) against the JAX package's examples/*.py:

- vi_smoother_demo --cpu --keyframes 10 (float32 on both sides, as the JAX
  example fixes it; its numbers are what it prints): the ATEs and bias
  errors (4 decimals) within 2e-4 + 1e-3 relative, the VI-BA and
  vi_initialize scales (3 decimals) within 2e-3, gravity (2 decimals)
  within 0.02; the LM iteration counts are float32 stop decisions and are
  not compared. The VI-BA solve in float32 also holds common.linearize to
  the residual's dtype (in forward mode, a 0-d float32 tensor times a
  Python number can carry a float64 tangent);
- kitti_vo_demo's PNG reader (the standard library's zlib) against
  cv2.imread(IMREAD_GRAYSCALE) on seeded frames cv2 writes with each of
  the five row filters, and its refusal of other kinds of PNG;
- kitti_vo_demo on a synthetic 6-frame clip (KITTI's 1241 x 376 at its
  intrinsics, a camera driving 0.8 m a frame down a textured corridor):
  the frames read by both packages' loaders equal, the LK tracks
  (track_sequence, float32) equal in count and alive mask and within
  1e-2 px of the JAX package's, and the port's pipeline end to end within
  the JAX test's gates (RMS < 5 px, forward fraction > 0.7, rotation < 10
  degrees). The pipeline itself is not compared: its robust epipolar
  RANSAC draws its subsets from another random stream in each package;
- the pipeline on the reference's KITTI frames, with the JAX test's gates,
  skips where they are not mounted (as tests/test_kitti_vo.py).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from slam_tricks_tpu_torch.examples import kitti_vo_demo, vi_smoother_demo
from slam_tricks_tpu_torch.manifolds import lie, so3
from slam_tricks_tpu_torch.solvers.common import linearize
from tests.test_kitti_vo import REF
from tests.torch_util import (ROOT, printed_numbers, run_jax_example,
                              run_port_example)


@pytest.fixture(scope="module")
def jax_vi():
    _, out = run_jax_example("vi_smoother_demo",
                             ["--cpu", "--keyframes", "10"])
    return printed_numbers(out)


def test_vi_smoother_demo_matches_jax(jax_vi):
    out, _, printed = run_port_example(vi_smoother_demo,
                                       ["--cpu", "--keyframes", "10"])
    j = jax_vi
    assert len(j) == len(printed_numbers(printed)) == 12
    for got, ref in ((out["dead_reckoning_ate"], j[0]),
                     (out["observation_ate"], j[1]),
                     (out["smoother_ate"], j[2]), (out["bias_err0"], j[4]),
                     (out["bias_err"], j[5])):
        assert abs(got - ref) <= 2e-4 + 1e-3 * abs(ref), (got, ref)
    assert abs(out["vi_ba_scale"] - j[7]) <= 2e-3
    assert abs(out["vi_init_scale"] - j[8]) <= 2e-3
    assert np.allclose(out["gravity"], j[9:12], atol=0.02)
    assert out["smoother_ate"] < out["observation_ate"]
    assert abs(out["vi_ba_scale"] - 1.0) < 0.03


def test_linearize_keeps_the_residual_dtype():
    R0 = so3.exp(torch.tensor([0.1, 0.2, 0.3]))
    r, J = linearize(lambda R: so3.log(R.mT @ R0), lie(so3),
                     so3.exp(torch.tensor([0.1, 0.2, 0.31])))
    assert r.dtype == J.dtype == torch.float32 and J.shape == (3, 3)


# ---- kitti_vo_demo ----

def _write_png(path, img, filters):
    """An 8-bit grayscale PNG of `img` whose row y uses filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w = img.shape
    x = img.astype(np.int64)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        up = x[y - 1] if y else np.zeros(w, np.int64)
        left = np.concatenate([[0], x[y, :-1]])
        ul = np.concatenate([[0], up[:-1]])
        if f == 0:
            pred = np.zeros(w, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((x[y] - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_png_reader_each_filter(tmp_path, filters):
    img = np.random.default_rng(len(filters) + filters[0]).integers(
        0, 256, (37, 53)).astype(np.uint8)
    _write_png(tmp_path / "f.png", img, filters)
    np.testing.assert_array_equal(
        kitti_vo_demo.read_png_gray(tmp_path / "f.png"), img)


def test_png_reader_matches_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (376, 1241)).astype(np.uint8)
    smooth = cv2.GaussianBlur(noise, (0, 0), 3)
    for name, img in (("noise", noise), ("smooth", smooth)):
        for level in (0, 9):
            path = str(tmp_path / f"{name}{level}.png")
            cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            got = kitti_vo_demo.read_png_gray(path)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(
                got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    cv2.imwrite(str(tmp_path / "rgb.png"), np.dstack([smooth] * 3))
    cv2.imwrite(str(tmp_path / "g16.png"), smooth.astype(np.uint16) * 200)
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    for name in ("rgb.png", "g16.png", "not.png"):
        with pytest.raises(ValueError):
            kitti_vo_demo.read_png_gray(tmp_path / name)


def _render(z_cam, tex, shape=(376, 1241)):
    """A pinhole view (KITTI's intrinsics) from (0, 0, z_cam) looking down
    +z: a textured ground (y = 1.65), walls at x = -6 and 6 and a far wall
    80 m ahead, sampled bilinearly from the periodic texture `tex`."""
    from scipy import ndimage

    H, W = shape
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(u - kitti_vo_demo.CX) / kitti_vo_demo.FX,
                  (v - kitti_vo_demo.CY) / kitti_vo_demo.FY,
                  np.ones_like(u)], -1)
    depth = 80.0 / d[..., 2]
    P = d * depth[..., None]
    coords = [(P[..., 1] + 10) * 20, (P[..., 0] + 20) * 20]
    for axis, off in ((1, 1.65), (0, -6.0), (0, 6.0)):
        s = off / np.where(np.abs(d[..., axis]) < 1e-9, 1e-9, d[..., axis])
        hit = (s > 0) & (s < depth)
        Q = d * s[..., None]
        b = Q[..., 0] if axis == 1 else Q[..., 1]
        depth = np.where(hit, s, depth)
        coords = [np.where(hit, (b + 10) * 40, coords[0]),
                  np.where(hit, (Q[..., 2] + z_cam) * 40, coords[1])]
    n = tex.shape[0]
    img = ndimage.map_coordinates(tex, [c.ravel() % n for c in coords],
                                  order=1, mode="wrap").reshape(H, W)
    return np.round(img * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """Six frames of the synthetic drive, written as 8-bit PNGs."""
    from scipy import ndimage

    rng = np.random.default_rng(0)
    tex = sum(ndimage.gaussian_filter(rng.random((1024, 1024)), s,
                                      mode="wrap") * s for s in (1, 2, 4))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    d = tmp_path_factory.mktemp("clip")
    for k in range(6):
        _write_png(d / f"{k:06d}.png", _render(0.8 * k, tex), (1, 2, 4))
    return d


def _jax_kitti():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_example_kitti_vo_demo", ROOT / "examples" / "kitti_vo_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kitti_tracks_match_jax(clip):
    pytest.importorskip("cv2")
    jk = _jax_kitti()
    frames = kitti_vo_demo.load_frames(clip)
    jframes = jk.load_frames(str(clip))
    assert len(frames) == len(jframes) == 6
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)
    uv, alive = kitti_vo_demo.track_sequence(frames, torch.device("cpu"))
    juv, jalive = jk.track_sequence(jframes)
    assert uv.shape == juv.shape == (6, 288, 2)
    np.testing.assert_array_equal(alive, jalive)
    assert alive[-1].sum() > 200
    assert np.abs(uv[:, alive[-1]] - juv[:, alive[-1]]).max() < 1e-2


def test_kitti_pipeline_on_a_synthetic_clip(clip):
    out = kitti_vo_demo.main(["--cpu", "--frames", str(clip)])
    assert out["rms_px"] < 5.0 and out["fwd_frac"] > 0.7
    assert out["max_rot_deg"] < 10.0 and out["tracks"] > 50
    assert torch.isfinite(out["state"].points).all()


def test_kitti_vo_end_to_end():
    if not os.path.isdir(REF):
        pytest.skip("reference KITTI frames not mounted")
    out = kitti_vo_demo.main(["--cpu", "--frames", REF])
    assert out["rms_px"] < 5.0, out["rms_px"]
    assert out["fwd_frac"] > 0.7, out["fwd_frac"]
    assert out["max_rot_deg"] < 10.0, out["max_rot_deg"]
