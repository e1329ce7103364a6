"""Host-side observation partitioning for distributed BA (port of
``slam_tricks_tpu/parallel/partition.py``).

The distribution unit is the landmark track: all observations of a
landmark are placed on one rank, so the landmark elimination and the
within-track pair products that form the off-diagonal Schur mass are the
rank's own, and the only reductions across ranks are pose-sized (and, on
the replicated paths, the landmark blocks). Numpy on the host, the JAX
package's layout; the results are tensors on the observations' device.
"""

from typing import NamedTuple

import numpy as np
import torch


class LocalPairs(NamedTuple):
    """Each rank's within-track observation pairs, indices local to the
    rank's rows of the partitioned observations (0 .. chunk_len). Shapes
    (n_devices, n_chunks, chunk); rank d takes [d]. pair_w is 1 for a < b,
    0.5 for a == b and 0 for padding."""
    pair_a: torch.Tensor    # int32
    pair_b: torch.Tensor    # int32
    pair_w: torch.Tensor    # dtype


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def partition_obs_by_landmark(obs, n_devices):
    """Sort the observations by landmark, split them into n_devices runs at
    landmark boundaries (each cut at the boundary at or after an equal
    split), and pad every run to one length, a multiple of 8. Returns
    observations of `obs`'s type with (n_devices * chunk_len, ...) rows:
    rank d owns rows [d chunk_len, (d + 1) chunk_len). Padding rows have
    weight 0 and indices 0."""
    device = obs.uv.device
    cam_idx, lm_idx = _host(obs.cam_idx), _host(obs.lm_idx)
    uv, w = _host(obs.uv), _host(obs.weight)
    order = np.argsort(lm_idx, kind="stable")
    cam_idx, lm_idx, uv, w = cam_idx[order], lm_idx[order], uv[order], w[order]
    n = len(order)

    cuts = [0]
    for d in range(1, n_devices):
        target = d * n // n_devices
        while 0 < target < n and lm_idx[target] == lm_idx[target - 1]:
            target += 1
        cuts.append(min(target, n))
    cuts.append(n)
    chunks = [slice(cuts[i], cuts[i + 1]) for i in range(n_devices)]
    chunk_len = max(c.stop - c.start for c in chunks)
    chunk_len = chunk_len + (-chunk_len) % 8

    def pad(a):
        out = np.zeros((n_devices * chunk_len,) + a.shape[1:], a.dtype)
        for i, c in enumerate(chunks):
            out[i * chunk_len:i * chunk_len + (c.stop - c.start)] = a[c]
        return torch.as_tensor(out, device=device)

    return type(obs)(cam_idx=pad(cam_idx), lm_idx=pad(lm_idx), uv=pad(uv),
                     weight=pad(w))


def build_local_pairs(obs_part, n_devices, *, chunk=65536,
                      dtype=torch.float32):
    """Every within-track observation pair (a <= b) of each rank, indices
    local to the rank's rows of `obs_part` (from
    ``partition_obs_by_landmark``: track locality puts every pair on one
    rank), each rank padded to one (n_chunks, chunk) shape with weight-0
    pairs at index 0. The distributed form of ``schur.build_track_pairs``.
    Returns LocalPairs on the observations' device."""
    device = obs_part.uv.device
    lm_idx, w = _host(obs_part.lm_idx), _host(obs_part.weight)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    n_total = lm_idx.shape[0]
    if n_total % n_devices:
        raise ValueError(f"{n_total} observations do not split into "
                         f"{n_devices} equal runs")
    chunk_len = n_total // n_devices

    per_dev = []
    max_pairs = 0
    for d in range(n_devices):
        sl = slice(d * chunk_len, (d + 1) * chunk_len)
        lm_d, w_d = lm_idx[sl], w[sl]
        valid = np.flatnonzero(w_d > 0)
        order = valid[np.argsort(lm_d[valid], kind="stable")].astype(np.int32)
        lm_sorted = lm_d[order]
        if order.size:
            starts = np.flatnonzero(np.r_[True,
                                          lm_sorted[1:] != lm_sorted[:-1]])
            ends = np.r_[starts[1:], lm_sorted.shape[0]]
        else:
            starts = ends = np.zeros(0, np.int64)
        lengths = ends - starts
        # the pairs of the tracks of each length at once
        a_list, b_list = [], []
        for k in np.unique(lengths):
            if k == 0:
                continue
            tr = np.flatnonzero(lengths == k)
            M = order[starts[tr][:, None] + np.arange(k)[None, :]]
            ii, jj = np.triu_indices(int(k))
            a_list.append(M[:, ii].ravel())
            b_list.append(M[:, jj].ravel())
        pa = np.concatenate(a_list) if a_list else np.zeros(0, np.int32)
        pb = np.concatenate(b_list) if b_list else np.zeros(0, np.int32)
        pw = np.where(pa == pb, 0.5, 1.0).astype(np_dtype)
        per_dev.append((pa, pb, pw))
        max_pairs = max(max_pairs, pa.shape[0])

    chunk = min(chunk, max(max_pairs, 1))
    p_pad = max_pairs + (-max_pairs) % chunk
    if p_pad == 0:
        p_pad = chunk
    n_chunks = p_pad // chunk
    pa_all = np.zeros((n_devices, n_chunks, chunk), np.int32)
    pb_all = np.zeros((n_devices, n_chunks, chunk), np.int32)
    pw_all = np.zeros((n_devices, n_chunks, chunk), np_dtype)
    for d, (pa, pb, pw) in enumerate(per_dev):
        k = pa.shape[0]
        pa_all[d].reshape(-1)[:k] = pa
        pb_all[d].reshape(-1)[:k] = pb
        pw_all[d].reshape(-1)[:k] = pw
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return LocalPairs(pair_a=t(pa_all), pair_b=t(pb_all), pair_w=t(pw_all))
