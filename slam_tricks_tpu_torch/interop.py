"""The JAX package's state as the port's tensors.

Each function takes the JAX package's objects (``se3.SE3``, ``sim3.Sim3``,
``PreintegratedImu``, ``ViSimData``, ``ESKFState``, ``INSState``,
``PoseGraphProblem``, ``posegraph.ChainGraphWork``, ``BAObservations``, ``schur_flat_sm.SlotWork``, ``banded_flat.BandedWork``,
``loop_flat.LoopWork``, ``schur_flat.FlatWork``, ``pcg_flat.PCGWork``,
``schur.TrackPairs``, ``pcg.BandPairs``, ``sliding_window.WindowPrior``,
``parallel``'s ``LocalPairs``, ``DistBandedWork``, ``DistLoopWork`` and
``DistPCGWork``,
``camera.Intrinsics``, ``camera.DistCoeffs``, ``CalibScene``,
``TwoViewScene``, ``OrbFeatures``, ``LidarSweep``) or anything else whose
fields numpy can read, copies every array through numpy and returns the
port's counterpart on `device`, the card unless the caller names another
(``device="cpu"``). Nothing here imports jax: a JAX array is
read as a numpy array. ``checkpoint_from_jax`` reads a checkpoint file the
JAX package wrote.
"""

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.estimation.eskf import ESKFState
from slam_tricks_tpu_torch.estimation.ins import INSState
from slam_tricks_tpu_torch.estimation.preintegration import PreintegratedImu
from slam_tricks_tpu_torch.estimation.vi_smoother import ViSimData
from slam_tricks_tpu_torch.frontend.orb import OrbFeatures
from slam_tricks_tpu_torch.manifolds.se3 import SE3
from slam_tricks_tpu_torch.manifolds.sim3 import Sim3
from slam_tricks_tpu_torch.ops.ba_assemble import layout_index
from slam_tricks_tpu_torch.parallel.banded_dist import DistBandedWork
from slam_tricks_tpu_torch.parallel.loop_dist import DistLoopWork
from slam_tricks_tpu_torch.parallel.partition import LocalPairs
from slam_tricks_tpu_torch.parallel.pcg_dist import DistPCGWork
from slam_tricks_tpu_torch.residuals.camera import DistCoeffs, Intrinsics
from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
from slam_tricks_tpu_torch.sim.calib_scene import CalibScene
from slam_tricks_tpu_torch.sim.distortion import LidarSweep
from slam_tricks_tpu_torch.sim.two_view import TwoViewScene
from slam_tricks_tpu_torch.sim.trajectory import PoseGraphProblem
from slam_tricks_tpu_torch.solvers.banded_flat import BandedWork, chunk_table
from slam_tricks_tpu_torch.solvers.loop_flat import LoopWork
from slam_tricks_tpu_torch.solvers.pcg import BandPairs
from slam_tricks_tpu_torch.solvers.pcg_flat import pcg_work_from_tables
from slam_tricks_tpu_torch.solvers.posegraph import ChainGraphWork
from slam_tricks_tpu_torch.solvers.schur import TrackPairs, TrackTable
from slam_tricks_tpu_torch.solvers.schur_flat import (flat_work_from_table,
                                                      obs_slots)
from slam_tricks_tpu_torch.solvers.schur_flat_sm import SlotWork, slot_tables
from slam_tricks_tpu_torch.solvers.sliding_window import WindowPrior
from slam_tricks_tpu_torch.utils.checkpoint import read_leaves


def tensor(a, device=None):
    """A copy of the array `a` as a tensor on `device` (the card unless the
    caller names another), dtype kept."""
    return torch.as_tensor(np.array(a), device=resolve(device))


def poses_from_jax(poses, device=None):
    """SE3 with R (C, 3, 3), t (C, 3)."""
    return SE3(tensor(poses.R, device), tensor(poses.t, device))


def sim3_from_jax(S, device=None):
    """Sim3 with R (N, 3, 3), t (N, 3), s (N,)."""
    return Sim3(tensor(S.R, device), tensor(S.t, device), tensor(S.s, device))


def pose_graph_problem_from_jax(prob, device=None):
    """``sim.trajectory.PoseGraphProblem``; edge indices as int64."""
    return PoseGraphProblem(
        poses_true=poses_from_jax(prob.poses_true, device),
        poses_init=poses_from_jax(prob.poses_init, device),
        i_idx=tensor(prob.i_idx, device).long(),
        j_idx=tensor(prob.j_idx, device).long(),
        Z=poses_from_jax(prob.Z, device),
        fixed_mask=tensor(prob.fixed_mask, device))


def chain_work_from_jax(work, device=None):
    """``posegraph.ChainGraphWork``; loop indices as int64."""
    return ChainGraphWork(Z_chain=poses_from_jax(work.Z_chain, device),
                          info_chain=tensor(work.info_chain, device),
                          loop_i=tensor(work.loop_i, device).long(),
                          loop_j=tensor(work.loop_j, device).long(),
                          Z_loop=poses_from_jax(work.Z_loop, device),
                          info_loop=tensor(work.info_loop, device))


def obs_from_jax(obs, device=None):
    return BAObservations(cam_idx=tensor(obs.cam_idx, device),
                          lm_idx=tensor(obs.lm_idx, device),
                          uv=tensor(obs.uv, device),
                          weight=tensor(obs.weight, device))


def slot_work_from_jax(work, device=None):
    """The JAX SlotWork's slot grid, its summation tables, and on a CUDA
    device its camera index; its camera one-hot or gather table is not
    carried over (the port gathers with cam_of_slot)."""
    w, cam = tensor(work.w, device), tensor(work.cam_of_slot, device)
    mask, C = tensor(work.mask, device), int(work.n_cams)
    b_table, cam_table = slot_tables(cam, mask, C)
    return SlotWork(uv0=tensor(work.uv0, device), uv1=tensor(work.uv1, device),
                    w=w, mask=mask, cam_of_slot=cam,
                    cam_index=layout_index(w, cam, C), b_table=b_table,
                    cam_table=cam_table, n_cams=C)


def banded_work_from_jax(work, n_points, device=None):
    """The JAX BandedWork's slot grid, indices and chunk cameras, and on a
    CUDA device the grid's camera index; its (chunks, C) one-hot becomes
    each chunk's first camera (its argmax)."""
    onehot = np.array(work.onehot)
    uv = np.array(work.uv)                           # (K, 2, Lpad)
    K, Lpad = uv.shape[0], uv.shape[2]
    C = onehot.shape[1]
    c0 = np.argmax(onehot, axis=1).astype(np.int64)   # (chunks,)
    slot_c0 = np.repeat(c0, Lpad // c0.shape[0])
    cam_of_slot = (slot_c0[None, :] + np.arange(K)[:, None]) % C
    w = tensor(work.weight, device)
    cam = tensor(cam_of_slot.astype(np.int32), device)
    c0_t = tensor(c0, device)
    return BandedWork(
        uv0=tensor(uv[:, 0], device), uv1=tensor(uv[:, 1], device),
        w=w, cam_of_slot=cam, cam_index=layout_index(w, cam, C),
        cam_table=chunk_table(c0_t, K, C), c0=c0_t,
        scatter_idx=tensor(np.array(work.scatter_idx).astype(np.int64), device),
        gather_idx=tensor(np.array(work.gather_idx).astype(np.int64), device),
        n_cams=C, n_points=int(n_points))


def loop_work_from_jax(work, n_points, device=None):
    """The JAX LoopWork: its banded part through ``banded_work_from_jax``,
    its loop-closure grid, support rows and landmark indices."""
    uv = np.array(work.lc_uv)                        # (Klc, 2, Mpad)
    return LoopWork(
        banded=banded_work_from_jax(work.banded, n_points, device),
        lc_uv0=tensor(uv[:, 0], device), lc_uv1=tensor(uv[:, 1], device),
        lc_w=tensor(work.lc_weight, device),
        lc_aslot=tensor(np.array(work.lc_aslot).astype(np.int64), device),
        lc_lm=tensor(np.array(work.lc_lm).astype(np.int64), device),
        lc_gather=tensor(np.array(work.lc_gather).astype(np.int64), device),
        onehot_A=tensor(work.onehot_A, device))


def intrinsics_from_jax(intr, device=None):
    """Intrinsics of 0-d tensors."""
    return Intrinsics(*(tensor(v, device) for v in intr))


def dist_from_jax(dist, device=None):
    """DistCoeffs of 0-d tensors."""
    return DistCoeffs(*(tensor(v, device) for v in dist))


def calib_scene_from_jax(scene, device=None):
    """``sim.calib_scene.CalibScene``: the arrays and poses as tensors, the
    true distortion as 0-d tensors, the intrinsics as floats."""
    return CalibScene(board_pts=tensor(scene.board_pts, device),
                      image_pts=tensor(scene.image_pts, device),
                      poses_true=poses_from_jax(scene.poses_true, device),
                      fx=float(scene.fx), fy=float(scene.fy),
                      cx=float(scene.cx), cy=float(scene.cy),
                      dist_true=dist_from_jax(scene.dist_true, device))


def two_view_from_jax(scene, device=None):
    """``sim.two_view.TwoViewScene``."""
    return TwoViewScene(T1=poses_from_jax(scene.T1, device),
                        T2=poses_from_jax(scene.T2, device),
                        points=tensor(scene.points, device),
                        uv1=tensor(scene.uv1, device),
                        uv2=tensor(scene.uv2, device),
                        T_12=poses_from_jax(scene.T_12, device))


def orb_features_from_jax(f, device=None):
    """``frontend.orb.OrbFeatures``."""
    return OrbFeatures(*(tensor(v, device) for v in f))


def lidar_sweep_from_jax(sweep, device=None):
    """``sim.distortion.LidarSweep``."""
    return LidarSweep(*(tensor(v, device) for v in sweep))


def _flat_table(work):
    """The track table of a JAX FlatWork (numpy); in grid mode, where it
    keeps none, row l K + k is slot k of landmark l."""
    if work.table is not None:
        return TrackTable(obs_idx=np.array(work.table.obs_idx),
                          mask=np.array(work.table.mask))
    mask = np.array(work.mask_lk)
    L, K = mask.shape
    return TrackTable(obs_idx=np.arange(L * K, dtype=np.int32).reshape(L, K),
                      mask=mask)


def flat_work_from_jax(work, obs, n_cams, device=None):
    """The port's FlatWork with the slot grid of the JAX FlatWork's track
    table (or grid layout) over the observations `obs` it was built from;
    its one-hot or camera table is not carried over (the port gathers)."""
    table = _flat_table(work)
    obs_t = obs_from_jax(obs, device)
    return flat_work_from_table(obs_t, table, n_cams, obs_t.uv.dtype)


def pcg_work_from_jax(pcg_work, flat_work, device=None):
    """The JAX PCGWork's tables, observation ids translated to the slot ids
    of the port's FlatWork of the JAX `flat_work` (``flat_work_from_jax``)."""
    table = _flat_table(flat_work)
    mask = np.array(pcg_work.cam_mask)
    tables = (np.array(pcg_work.cam_table), mask, np.array(pcg_work.adj_a),
              np.array(pcg_work.adj_b), np.array(pcg_work.adj_mask))
    dtype = torch.float64 if mask.dtype == np.float64 else torch.float32
    return pcg_work_from_tables(tables, obs_slots(table),
                                table.obs_idx.shape[0], resolve(device),
                                dtype)


def _device_slice(x, d):
    """Device d's slice of a JAX nest stacked on a leading device axis, as
    the same nest type of numpy arrays (None kept)."""
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return type(x)(*(_device_slice(f, d) for f in x))
    return np.array(x)[d]


def local_pairs_from_jax(pairs, device=None):
    """``parallel.partition.LocalPairs`` (n_devices, n_chunks, chunk)."""
    return LocalPairs(*(tensor(a, device) for a in pairs))


def dist_banded_work_from_jax(work, device=None):
    """The JAX DistBandedWork as the port's: each device's slice of its
    stacked BandedWork through ``banded_work_from_jax``."""
    D = np.array(work.local.weight).shape[0]
    return DistBandedWork(
        local=tuple(banded_work_from_jax(_device_slice(work.local, d),
                                         work.n_points, device)
                    for d in range(D)),
        n_points=int(work.n_points))


def dist_loop_work_from_jax(work, device=None):
    """The JAX DistLoopWork: its banded slices as in
    ``dist_banded_work_from_jax``, the whole LoopWork through
    ``loop_work_from_jax``."""
    D = np.array(work.banded_local.weight).shape[0]
    return DistLoopWork(
        banded_local=tuple(banded_work_from_jax(
            _device_slice(work.banded_local, d), work.n_points, device)
            for d in range(D)),
        lc=loop_work_from_jax(work.lc, work.n_points, device),
        n_points=int(work.n_points))


def dist_pcg_work_from_jax(work, device=None):
    """The JAX DistPCGWork: each device's slice of its stacked FlatWork
    (built with a camera table, so the port's has no B table) and PCGWork
    through ``flat_work_from_jax`` and ``pcg_work_from_jax``."""
    D = np.array(work.obs_cam).shape[0]
    C = np.array(work.pcg.cam_table).shape[1]
    flat, pcgw = [], []
    for d in range(D):
        obs = BAObservations(cam_idx=np.array(work.obs_cam)[d],
                             lm_idx=np.array(work.obs_lm)[d],
                             uv=np.array(work.obs_uv)[d],
                             weight=np.array(work.obs_w)[d])
        fw_d = _device_slice(work.flat, d)
        fw = flat_work_from_jax(fw_d, obs, C, device)
        flat.append(fw._replace(slot=fw.slot._replace(b_table=None)))
        pcgw.append(pcg_work_from_jax(_device_slice(work.pcg, d), fw_d,
                                      device))
    return DistPCGWork(
        obs_cam=tensor(work.obs_cam, device),
        obs_lm=tensor(work.obs_lm, device),
        obs_uv=tensor(work.obs_uv, device), obs_w=tensor(work.obs_w, device),
        flat=tuple(flat), pcg=tuple(pcgw),
        lm_global=tensor(work.lm_global, device).long(),
        n_points_local=int(work.n_points_local), n_points=int(work.n_points))


def track_pairs_from_jax(pairs, device=None):
    return TrackPairs(*(tensor(a, device) for a in pairs))


def band_pairs_from_jax(band_pairs, device=None):
    return BandPairs(*(tensor(a, device) for a in band_pairs))


def window_prior_from_jax(prior, device=None):
    return WindowPrior(*(tensor(a, device) for a in prior))


def preintegrated_from_jax(pre, device=None):
    """PreintegratedImu, every field batched as the JAX package's."""
    return PreintegratedImu(*(tensor(f, device) for f in pre))


def vi_sim_from_jax(sim, device=None):
    """ViSimData: the poses as SE3, dt a float."""
    return ViSimData(poses_from_jax(sim.poses_true, device),
                     tensor(sim.vels_true, device), tensor(sim.gyro, device),
                     tensor(sim.accel, device), float(sim.dt),
                     poses_from_jax(sim.obs_poses, device),
                     tensor(sim.bg_true, device), tensor(sim.ba_true, device))


def eskf_state_from_jax(state, device=None):
    """ESKFState with T (SE3) and P (6, 6)."""
    return ESKFState(poses_from_jax(state.T, device), tensor(state.P, device))


def ins_state_from_jax(state, device=None):
    """INSState: lat, lon, h, v_ned (3,), q_nb (4,)."""
    return INSState(*(tensor(f, device) for f in state))


def checkpoint_from_jax(path, like, device=None):
    """A ``.npz`` written by the JAX package's ``utils.checkpoint.save_pytree``
    (e.g. a ``BAState``) as the port's nest `like` (e.g. the port's
    ``BAState``): the leaves in ``jax.tree_util``'s order, which
    ``utils.checkpoint`` shares, checked against `like`'s leaf count and
    shapes (not the stored structure string, which names JAX classes),
    tensors to `like`'s dtypes on `device`, the card unless the caller names
    another."""
    with np.load(path) as data:
        return read_leaves(data, like, resolve(device))
