"""The distributed solvers' host layouts, slam_tricks_tpu_torch/parallel/
{partition,banded_dist,loop_dist,pcg_dist}.py, against the JAX package's
parallel/ modules.

- partition_obs_by_landmark and build_local_pairs on the cube room of
  tests/test_landmark_local.py (make_scene(n_per_wall=10, n_cams=6,
  seed=51)) at D = 2, 3 and 8 ranks: bitwise equal arrays, the locality
  invariant of tests/test_landmark_local.py:23-52 (a landmark's
  observations on one rank, none lost), and the pairs cover every track.
- For each rank d, the port's split_banded_work (through
  build_dist_banded_work), build_dist_loop_work and build_dist_work equal
  the port's conversion (interop.dist_*_from_jax) of the JAX package's
  slice d, bitwise, at D = 2 and 3 (3: pad chunks, an uneven split), on
  the 16-camera trajectory of tests/test_multihost.py and the smallest
  loop scene of tests/test_loop_dist.py.
"""

import numpy as np
import pytest
import torch

from slam_tricks_tpu.parallel import banded_dist as jbd
from slam_tricks_tpu.parallel import loop_dist as jld
from slam_tricks_tpu.parallel import partition as jpart
from slam_tricks_tpu.parallel import pcg_dist as jpd
from slam_tricks_tpu.sim import make_loop_scene as jmake_loop
from slam_tricks_tpu.sim import make_scene as jmake_scene
from slam_tricks_tpu.sim import make_trajectory_scene as jmake_trajectory
from slam_tricks_tpu_torch import interop
from slam_tricks_tpu_torch.parallel import (banded_dist, loop_dist,
                                            partition, pcg_dist)
import tests.torch_util  # noqa: F401  (caps torch's threads)

f64 = torch.float64


def _assert_same(port, ref, where=""):
    """Two nests of the port's types equal: tensors bitwise with one dtype,
    other leaves equal."""
    if isinstance(ref, torch.Tensor):
        assert isinstance(port, torch.Tensor), where
        assert port.dtype == ref.dtype, (where, port.dtype, ref.dtype)
        assert torch.equal(port, ref), where
    elif isinstance(ref, tuple):
        assert type(port) is type(ref) and len(port) == len(ref), where
        names = getattr(ref, "_fields", range(len(ref)))
        for name, a, b in zip(names, port, ref):
            _assert_same(a, b, f"{where}.{name}")
    else:
        assert port == ref, (where, port, ref)


@pytest.fixture(scope="module")
def cube():
    jsc = jmake_scene(n_per_wall=10, n_cams=6, seed=51)
    return jsc, interop.obs_from_jax(jsc.obs, "cpu")


@pytest.mark.parametrize("D", [2, 3, 8])
def test_partition_matches_jax(cube, D):
    jsc, obs = cube
    ref = jpart.partition_obs_by_landmark(jsc.obs, D)
    got = partition.partition_obs_by_landmark(obs, D)
    for name, a, b in zip(ref._fields, got, ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        assert np.array_equal(a.numpy(), b), name

    pairs_ref = jpart.build_local_pairs(ref, D, dtype=np.float64)
    pairs = partition.build_local_pairs(got, D, dtype=f64)
    for name, a, b in zip(pairs_ref._fields, pairs, pairs_ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        assert np.array_equal(a.numpy(), b), name


@pytest.mark.parametrize("D", [2, 3, 8])
def test_partition_locality_invariant(cube, D):
    jsc, obs = cube
    part = partition.partition_obs_by_landmark(obs, D)
    n = part.cam_idx.shape[0]
    assert n % D == 0
    chunk = n // D
    lm, w = part.lm_idx.numpy(), part.weight.numpy()
    owner = {}
    for d in range(D):
        sl = slice(d * chunk, (d + 1) * chunk)
        for l in np.unique(lm[sl][w[sl] > 0]):
            assert owner.setdefault(l, d) == d, f"landmark {l} split"
    assert w.sum() == obs.weight.numpy().sum()      # none lost
    # every track's pairs a <= b, each on the rank of its landmark
    pairs = partition.build_local_pairs(part, D)
    counts = np.bincount(lm[w > 0])
    assert int((pairs.pair_w > 0).sum()) == int(np.sum(counts * (counts + 1)
                                                       // 2))


@pytest.fixture(scope="module")
def trajectory():
    jsc = jmake_trajectory(n_cams=16, n_points=240, track_len=4, seed=73,
                           dtype=np.float64)
    return jsc, interop.obs_from_jax(jsc.obs, "cpu")


@pytest.mark.parametrize("D", [2, 3])
def test_split_banded_work_matches_jax_slices(trajectory, D):
    jsc, obs = trajectory
    ref = jbd.build_dist_banded_work(jsc.obs, 16, 240, D, dtype=np.float64)
    got = banded_dist.build_dist_banded_work(obs, 16, 240, D, dtype=f64)
    want = interop.dist_banded_work_from_jax(ref, "cpu")
    assert len(got.local) == D
    _assert_same(got, want, "DistBandedWork")
    if D == 3:      # the uneven split: pad chunks at the end of the last
        last = got.local[-1]
        pad = last.scatter_idx == 240
        assert pad.any() and (last.w[:, pad] == 0).all()


@pytest.mark.parametrize("D", [2, 3])
def test_dist_loop_work_matches_jax_slices(D):
    kw = dict(n_cams=32, n_points=600, track_len=4, seed=97)
    jsc = jmake_loop(dtype=np.float64, pix_noise=1e-3, **kw)
    ref = jld.build_dist_loop_work(jsc.obs, 32, 600, D, dtype=np.float64,
                                   max_band=4)
    got = loop_dist.build_dist_loop_work(interop.obs_from_jax(jsc.obs, "cpu"),
                                         32, 600, D, dtype=f64, max_band=4)
    assert int((got.lc.lc_w.sum(0) > 0).sum()) > 0    # loop closures there
    _assert_same(got, interop.dist_loop_work_from_jax(ref, "cpu"),
                 "DistLoopWork")


@pytest.mark.parametrize("D", [2, 3])
def test_build_dist_work_matches_jax_slices(trajectory, D):
    jsc, obs = trajectory
    ref = jpd.build_dist_work(jpart.partition_obs_by_landmark(jsc.obs, D),
                              16, 240, D, dtype=np.float64)
    got = pcg_dist.build_dist_work(partition.partition_obs_by_landmark(obs, D),
                                   16, 240, D, dtype=f64)
    _assert_same(got, interop.dist_pcg_work_from_jax(ref, "cpu"),
                 "DistPCGWork")
