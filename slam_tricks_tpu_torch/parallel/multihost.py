"""Process-group set-up for the distributed solvers (port of
``slam_tricks_tpu/parallel/multihost.py``).

The JAX package runs one program over a device mesh spanning hosts
(``jax.distributed.initialize`` and a global mesh). The port runs one
process a rank: ``torch.distributed.init_process_group`` joins them, the
world group takes the mesh's place, and each rank holds only its own
shard. Gloo is the default backend: it reduces CPU and CUDA tensors (the
latter through host copies), so it also runs several ranks that share one
card, which NCCL refuses.
"""

from datetime import timedelta

import torch
import torch.distributed as dist

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.ops.ba_assemble import layout_index
from slam_tricks_tpu_torch.solvers.common import psum


def initialize_multihost(init_method=None, world_size=None, rank=None,
                         backend="gloo", timeout_s=300.0):
    """``torch.distributed.init_process_group`` for this process. With
    init_method, world_size and rank None it reads them from the
    environment (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK),
    as ``jax.distributed.initialize`` reads a pod's. Nothing on a machine
    tells a program of its cluster, so the caller names the rendezvous
    (``tcp://host:port`` or a ``file://`` path shared by the ranks). A
    collective that waits longer than timeout_s raises."""
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=timedelta(seconds=timeout_s))


def global_obs_mesh():
    """The group of every rank of every process: the world group, the
    counterpart of the JAX package's 1-D mesh over all devices."""
    return dist.group.WORLD


def host_local_slice(n_total, group=None):
    """(start, size) of this rank's slice of an axis of n_total split
    evenly over the group's ranks (the world when None)."""
    nproc = dist.get_world_size(group)
    if n_total % nproc:
        raise ValueError(f"pad the axis ({n_total}) to a multiple of the "
                         f"{nproc} ranks")
    size = n_total // nproc
    return dist.get_rank(group) * size, size


def make_global_array(local, group=None, device=None):
    """This rank's shard `local` (a tensor, or a nest of tuples and
    NamedTuples of tensors such as a work slice), on `device` (the card
    unless the caller names another). The port has no global array: where
    the JAX package assembles one ``jax.Array`` from every process's
    shard, each rank here holds only its own shard and the solvers reduce
    across ranks explicitly; group names the ranks the shard belongs to,
    as the JAX package's mesh does. A layout moved to another device gets
    its ``cam_index`` (the ``ba_assemble`` kernel's camera index) rebuilt
    from the moved tensors; tensors already on `device` are kept as they
    are."""
    del group
    return _to_device(local, resolve(device))


def _to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if not isinstance(x, (tuple, list)):
        return x
    if not hasattr(x, "_fields"):
        return type(x)(_to_device(item, device) for item in x)
    moved = {f: _to_device(getattr(x, f), device) for f in x._fields
             if f != "cam_index"}
    if "cam_index" in x._fields:
        same = moved["w"] is x.w and moved["cam_of_slot"] is x.cam_of_slot
        moved["cam_index"] = (x.cam_index if same else layout_index(
            moved["w"], moved["cam_of_slot"], x.n_cams))
    return type(x)(**moved)



def gather_owned(base, ids, rows, group=None):
    """The global (L, d) array from the rows each rank owns: this rank's
    rows (n, d) belong at ids (n,) (an id >= L is padding and dropped),
    every row of `base` has at most one owner, and a row no rank owns
    keeps base's value. Each rank writes its rows and a count column into
    a zero (L, d + 1) buffer and one ``all_reduce`` sums them: a sum of one
    value and zeros, so exact. The counterpart of the JAX package's
    per-device outputs scattered into the global array."""
    L, d = base.shape
    real = ids < L
    buf = base.new_zeros((L, d + 1))
    buf[ids[real], :d] = rows[real]
    buf[ids[real], d] = 1.0
    buf, = psum((buf,), group)
    return torch.where(buf[:, d:] > 0, buf[:, :d], base)
