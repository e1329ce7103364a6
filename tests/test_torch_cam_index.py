"""The camera-major index of the live slots
(slam_tricks_tpu_torch/ops/ba_assemble.py::camera_index), through which the
ba_assemble kernel sums the camera side in a fixed order.

On the headline layout (16-camera cube room, ``build_slot_work``) and the
trajectory layout (32 cameras, tracks of 6, ``build_banded_work``): every
live slot appears once, sorted by camera and by slot id within a camera;
segments never hold two cameras and start with a live slot; padding slots
(weight 0) are absent. Summing the plain per-slot camera columns through
the index, in segment order, gives ``linearize_assemble_plain``'s Hpp, gp
and cost to 1e-12 (f64, the same terms summed in another order). The
layouts converted from the JAX package index the same grids. On the CPU
the layouts keep no index (the plain version reads none), and
``linearize_assemble`` refuses an index that was not built from the very
grid it is given."""

import numpy as np
import pytest
import torch

from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu.solvers import banded_flat as jbf
from slam_tricks_tpu.solvers import schur_flat_sm as jsm
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.ops import ba_assemble
from slam_tricks_tpu_torch.sim import (make_scene, make_trajectory_scene,
                                       perturb_scene)
from slam_tricks_tpu_torch.solvers import banded_flat, schur_flat_sm
from tests.torch_util import rel_err

SCENE_A = dict(n_per_wall=60, n_cams=16, seed=3)
SCENE_B = dict(n_cams=32, n_points=600, track_len=6, seed=71)


def _layout(name, dtype=torch.float64):
    """(kernel arguments, work) of the headline ("A") or trajectory ("B")
    layout, on the CPU."""
    if name == "A":
        sc = make_scene(dtype=dtype, device="cpu", **SCENE_A)
        poses, points, _ = perturb_scene(sc, seed=4)
        work = schur_flat_sm.build_slot_work(sc.obs, sc.n_cams, sc.n_points,
                                             dtype=dtype)
    else:
        sc = make_trajectory_scene(dtype=dtype, device="cpu", **SCENE_B)
        poses, points, _ = perturb_scene(sc, pose_rot_noise=0.002,
                                         pose_trans_noise=0.01,
                                         point_noise=0.01, seed=72)
        work = banded_flat.build_banded_work(sc.obs, sc.n_cams, sc.n_points,
                                             dtype=dtype)
        points = points[work.gather_idx]
    C = work.n_cams
    args = (poses.R.reshape(C, 9), poses.t, points, work.uv0, work.uv1,
            work.w, work.cam_of_slot)
    return args, work


def _check_index(index, w, cam_of_slot, n_cams):
    seg = ba_assemble.SEGMENT
    slots = index.slots.numpy()
    seg_start = index.seg_start.numpy()
    cam = cam_of_slot.numpy().reshape(-1)
    assert index.slots.dtype == torch.int32 and slots.shape[1] == seg
    assert index.seg_start.dtype == torch.int32
    assert index.seg_cam.dtype == torch.int32
    np.testing.assert_array_equal(
        index.seg_cam.numpy(), np.repeat(np.arange(n_cams), np.diff(seg_start)))
    assert seg_start.shape == (n_cams + 1,) and seg_start[0] == 0
    assert seg_start[-1] == slots.shape[0]
    assert np.all(np.diff(seg_start) >= 0)
    # each live slot exactly once, padding slots absent
    ids = slots[slots >= 0]
    np.testing.assert_array_equal(np.sort(ids),
                                  np.flatnonzero(w.numpy().reshape(-1) > 0))
    # sorted by camera, stably: ascending slot ids within a camera
    cams = cam[ids]
    assert np.all(np.diff(cams) >= 0)
    same = np.diff(cams) == 0
    assert np.all(np.diff(ids)[same] > 0)
    for c in range(n_cams):
        segs = slots[seg_start[c]:seg_start[c + 1]]
        assert np.all(segs[:, 0] >= 0)                 # a segment starts live
        live = segs[segs >= 0]
        assert np.all(cam[live] == c)                  # one camera a segment
        assert live.shape[0] == np.count_nonzero(cam[ids] == c)
        # -1 pads only the end of the camera's last segment
        flat = segs.reshape(-1)
        assert np.all(flat[:live.shape[0]] >= 0)
        assert np.all(flat[live.shape[0]:] == -1)
        assert flat.shape[0] - live.shape[0] < seg


def _index(work):
    return ba_assemble.camera_index(work.w, work.cam_of_slot, work.n_cams)


@pytest.mark.parametrize("name", ["A", "B"])
def test_index_structure(name):
    _, work = _layout(name)
    _check_index(_index(work), work.w, work.cam_of_slot, work.n_cams)


@pytest.mark.parametrize("name", ["A", "B"])
def test_index_sums_match_plain(name):
    """The camera pass's order: each segment's slots summed, then each
    camera's segments in order; against the plain index_add_ sums."""
    args, work = _layout(name)
    C, index = work.n_cams, _index(work)
    (r0, r1), jp, _, cost_col = ba_assemble._linearize_sm(*args)
    cols = ba_assemble._camera_columns(jp, (r0, r1), cost_col).reshape(28, -1)
    cols = torch.cat([cols, torch.zeros_like(cols[:, :1])], dim=1)  # id -1
    partial = cols[:, index.slots.long()].sum(dim=-1)            # (28, n_seg)
    cam_red = torch.zeros((C, 28), dtype=cols.dtype)
    for c in range(C):
        for s in range(int(index.seg_start[c]), int(index.seg_start[c + 1])):
            cam_red[c] += partial[:, s]
    Hpp, gp, _, _, _, cost = ba_assemble.linearize_assemble_plain(*args)
    assert rel_err(cam_red[:, :21], Hpp) < 1e-12
    assert rel_err(cam_red[:, 21:27], gp) < 1e-12
    assert rel_err(cam_red[:, 27].sum(), cost) < 1e-12


@pytest.mark.parametrize("name", ["A", "B"])
def test_index_from_jax_matches_builder(name):
    """interop's slot_work_from_jax / banded_work_from_jax give the grid
    whose index the port's own layout builders' grid has; on the CPU both
    keep none."""
    if name == "A":
        jsc = jmake_scene(dtype=np.float64, **SCENE_A)
        conv = interop.slot_work_from_jax(
            jsm.build_slot_work(jsc.obs, jsc.n_cams, jsc.n_points,
                                dtype=np.float64), "cpu")
    else:
        jsc = jmake_trajectory(dtype=np.float64, **SCENE_B)
        conv = interop.banded_work_from_jax(
            jbf.build_banded_work(jsc.obs, jsc.n_cams, jsc.n_points,
                                  dtype=np.float64), jsc.n_points, "cpu")
    _, work = _layout(name)
    assert conv.cam_index is None and work.cam_index is None
    for a, b in zip(_index(conv)[:3], _index(work)[:3]):
        assert torch.equal(a, b)


def test_index_of_grid_without_live_slot():
    w = torch.zeros((3, 5))
    cam = torch.zeros((3, 5), dtype=torch.int32)
    index = ba_assemble.camera_index(w, cam, 4)
    assert tuple(index.slots.shape) == (0, ba_assemble.SEGMENT)
    assert index.seg_cam.shape == (0,)
    assert index.seg_start.tolist() == [0] * 5


def test_index_rejects_camera_out_of_range():
    w = torch.ones((2, 3))
    cam = torch.tensor([[0, 1, 2], [3, 0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError):
        ba_assemble.camera_index(w, cam, 2)


def test_index_rejects_negative_camera():
    w = torch.ones((2, 3))
    cam = torch.tensor([[0, 1, -1], [1, 0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError):
        ba_assemble.camera_index(w, cam, 2)


@pytest.mark.parametrize("case", ["other w", "other cameras", "w changed",
                                  "camera count"])
def test_linearize_assemble_rejects_foreign_index(case):
    """An index is taken only with the very w and cam_of_slot it was built
    from, unmodified, and their camera count."""
    args, work = _layout("A")
    C = work.n_cams
    index = _index(work)
    w, cam = work.w, work.cam_of_slot
    if case == "other w":
        w = w.clone()
    elif case == "other cameras":
        cam = cam.clone()
    elif case == "w changed":
        w = w.clone()
        index = ba_assemble.camera_index(w, cam, C)
        w[0, 0] = 0.0
    R_flat = args[0]
    if case == "camera count":
        R_flat = torch.cat([R_flat, R_flat[:1]])
    with pytest.raises(ValueError, match="cam_index"):
        ba_assemble.linearize_assemble(R_flat, args[1], args[2], args[3],
                                       args[4], w, cam, index)
    # the same index with its own grid is taken
    ba_assemble.linearize_assemble(*args, _index(work))
