"""Gather-only PCG on the Schur reduced camera system of the flat layout (port
of ``slam_tricks_tpu/solvers/pcg_flat.py``): the large-C path of
``schur_flat.solve_ba_flat(linear="pcg")``.

Every reduction is a table gather and a masked sum along the table, so
each has a fixed order (the card gives the same bits on every run):

- the slot grid (K, L) of ``schur_flat.FlatWork``: a landmark's slots;
- a camera table (C, Kc): the slots of each camera;
- an adjacency table (C-1, Ka): within-track slot pairs on cameras
  (c + 1, c), which give the exact first sub-diagonal blocks of S for the
  block-tridiagonal preconditioner (trajectory problems couple adjacent
  cameras most).

The JAX package's tables name observations; the port's name slots k L + l
of the grid, translated once when they are built. The preconditioner is
``pcg.make_tridiag_precond``, the stored block-Cholesky factor of
``banded_flat``.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.solvers.common import device_index, psum
from slam_tricks_tpu_torch.solvers.pcg import make_tridiag_precond, pcg
from slam_tricks_tpu_torch.solvers.schur import build_track_table
from slam_tricks_tpu_torch.solvers.schur_flat import FlatWork, obs_slots
from slam_tricks_tpu_torch.solvers.schur_flat_sm import (_DIAG6,
                                                         _inv3x3_flat,
                                                         _sym6_expand,
                                                         damp_hll)

# symmetric 3x3 column index: _SYM33[m][j] is the column of H[m, j]
_SYM33 = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]


class PCGWork(NamedTuple):
    """Static gather tables of the PCG path (built once a problem), in slot
    ids k L + l of the FlatWork grid; padding entries name slot 0 and are
    masked."""
    cam_table: torch.Tensor   # (C, Kc) int64 the slots of each camera
    cam_mask: torch.Tensor    # (C, Kc)
    lm_of_cam: torch.Tensor   # (C, Kc) int64 their landmarks
    adj_a: torch.Tensor       # (C-1, Ka) int64 a slot at camera c + 1
    adj_b: torch.Tensor       # (C-1, Ka) int64 a slot of its landmark at c
    adj_mask: torch.Tensor    # (C-1, Ka)
    n_points: int             # L of the grid the slot ids index

    def check(self, work: FlatWork):
        if work.slot.n_points != self.n_points:
            raise ValueError(f"pcg_work was built for {self.n_points} "
                             f"landmarks, the work has "
                             f"{work.slot.n_points}")


def pcg_tables(cam_idx, lm_idx, w, n_cams, dtype=np.float32):
    """The JAX package's tables in observation ids (numpy): (cam_table,
    cam_mask, adj_a, adj_b, adj_mask); the landmarks of the camera table
    follow from its slot ids."""
    C = n_cams
    valid = np.flatnonzero(w > 0)
    order = valid[np.argsort(cam_idx[valid], kind="stable")]
    counts = np.bincount(cam_idx[order], minlength=C)
    Kc = int(counts.max()) if counts.size else 1
    Kc = Kc + (-Kc) % 8
    cam_table = np.zeros((C, Kc), np.int32)
    cam_mask = np.zeros((C, Kc), dtype)
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(order.shape[0]) - starts[cam_idx[order]]
    cam_table[cam_idx[order], slot] = order
    cam_mask[cam_idx[order], slot] = 1

    # adjacency: sorted by (landmark, camera), consecutive entries of one
    # landmark on cameras c and c + 1 are exactly the sub-diagonal pairs
    order_l = valid[np.lexsort((cam_idx[valid], lm_idx[valid]))]
    lm_s = lm_idx[order_l]
    cam_s = cam_idx[order_l]
    is_adj = (lm_s[1:] == lm_s[:-1]) & (cam_s[1:] == cam_s[:-1] + 1)
    pa = order_l[1:][is_adj]          # at camera c + 1
    pb = order_l[:-1][is_adj]         # at camera c
    cb = cam_s[:-1][is_adj]
    rows = max(C - 1, 1)
    counts = np.bincount(cb, minlength=rows)
    Ka = max(int(counts.max()) if counts.size else 1, 1)
    Ka = max(Ka + (-Ka) % 8, 8)
    adj_a = np.zeros((rows, Ka), np.int32)
    adj_b = np.zeros((rows, Ka), np.int32)
    adj_mask = np.zeros((rows, Ka), dtype)
    o2 = np.argsort(cb, kind="stable")
    starts = np.zeros(rows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(o2.shape[0]) - starts[cb[o2]]
    adj_a[cb[o2], slot] = pa[o2]
    adj_b[cb[o2], slot] = pb[o2]
    adj_mask[cb[o2], slot] = 1
    return cam_table, cam_mask, adj_a, adj_b, adj_mask


def pcg_work_from_tables(tables, obs_slot, n_points, device, dtype):
    """PCGWork from the observation-id tables of ``pcg_tables`` and the
    slot of each observation (-1: none; only masked entries may name
    one)."""
    cam_table, cam_mask, adj_a, adj_b, adj_mask = tables
    slot_of = np.maximum(np.asarray(obs_slot), 0)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    mask_t = lambda a: t(a).to(dtype)  # noqa: E731
    cam_slots = slot_of[cam_table]
    return PCGWork(cam_table=t(cam_slots), cam_mask=mask_t(cam_mask),
                   lm_of_cam=t(cam_slots % n_points),
                   adj_a=t(slot_of[adj_a]), adj_b=t(slot_of[adj_b]),
                   adj_mask=mask_t(adj_mask), n_points=int(n_points))


def build_pcg_work(obs, n_cams, dtype=torch.float32, n_points=None):
    """Host side: the camera and adjacency tables of `obs`, in the slot ids
    of ``schur_flat.build_flat_work(obs, C, n_points)`` (n_points None:
    the largest landmark index + 1). On the observations' device."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cam = obs.cam_idx.cpu().numpy()
    lm = obs.lm_idx.cpu().numpy()
    w = obs.weight.cpu().numpy()
    if n_points is None:
        n_points = int(lm.max()) + 1
    table = build_track_table(cam, lm, w, n_points=n_points, dtype=np_dtype)
    obs_slot = np.full(cam.shape[0], -1, np.int64)
    slots = obs_slots(table)
    obs_slot[:slots.shape[0]] = slots
    return pcg_work_from_tables(pcg_tables(cam, lm, w, n_cams, np_dtype),
                                obs_slot, n_points, obs.uv.device, dtype)


def _block_mul_sym3(Wg, hcols):
    """Y = W Hsym for flat blocks: Wg (18, ...) rows i 3 + j of (6, 3), hcols
    6 symmetric-3x3 columns broadcastable to (...). Returns (18, ...)."""
    return torch.stack([sum(Wg[i * 3 + m] * hcols[_SYM33[m][j]]
                            for m in range(3))
                        for i in range(6) for j in range(3)])


def _pair_product(Ya, Wb):
    """Sum over the table's slot axis of Y[a] W[b]ᵀ: Ya, Wb (18, G, K) ->
    (G, 6, 6)."""
    rows = []
    for i in range(6):
        row = [sum(Ya[i * 3 + j] * Wb[i2 * 3 + j] for j in range(3)).sum(dim=1)
               for i2 in range(6)]
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def solve_rcs_pcg_flat(Hpp, gp, Hll, gl, W, lam, fixed_mask, work: FlatWork,
                       pcgw: PCGWork, *, cg_iters=100, cg_tol=1e-6,
                       psum_axis=None):
    """Gather-only PCG solve of the damped reduced camera system and the
    landmark back-substitution, from the blocks of
    ``schur_flat._iteration_quantities`` (Hpp (C, 21), gp (C, 6), Hll
    (6, L), gl (3, L), W (18, K, L)). Returns (dp (C, 6), dl (L, 3),
    diag_pp (C, 6), diag_ll (L, 3)).

    psum_axis: a process group whose ranks each hold their own landmarks
    (``parallel/pcg_dist``), Hpp and gp already summed over the ranks: every
    camera-side sum (the rhs, the preconditioner's blocks and each CG
    product's) is the rank's part and is summed over the ranks, (C, 6) a CG
    iteration, so that the CG loop runs alike on every rank; None: one
    process."""
    dtype, device = gp.dtype, gp.device
    K, L = work.slot.mask.shape
    dpp = torch.clamp_min(Hpp[:, device_index(_DIAG6, device)],
                          1e-12)                                  # (C, 6)
    Hpp_d = _sym6_expand(Hpp) + torch.diag_embed(lam * dpp)
    Hll_d, dll = damp_hll(Hll, lam)
    hinv = _inv3x3_flat(Hll_d)                                    # 6 x (L,)

    free = (~fixed_mask).to(dtype)
    freec = free[:, None]
    fixedc = fixed_mask.to(dtype)[:, None]

    # the grid's W (its own track layout) and the camera table's, built
    # once an LM iteration and read by every product
    m = work.slot.mask
    Wm = W * m
    cam = work.slot.cam_of_slot.long()
    Wflat = W.reshape(18, K * L)
    W_c = Wflat[:, pcgw.cam_table] * pcgw.cam_mask                # (18,C,Kc)
    lmc = pcgw.lm_of_cam

    def lm_reduce(x):
        """3 x (L,): the sum over each landmark's slots of Wᵀ x[cam]."""
        xc = x.T[:, cam]                                          # (6, K, L)
        return [sum(Wm[i * 3 + j] * xc[i] for i in range(6)).sum(dim=0)
                for j in range(3)]

    def cam_reduce(ucols):
        """(C, 6): the sum over each camera's slots of W u[lm]."""
        ug = [c[lmc] for c in ucols]                              # (C, Kc)
        return torch.stack(
            [sum(W_c[i * 3 + j] * ug[j] for j in range(3)).sum(dim=1)
             for i in range(6)], dim=1)

    def mat3vec(h, v):
        a, b, c, d, e, f = h
        return [a * v[0] + b * v[1] + c * v[2],
                b * v[0] + d * v[1] + e * v[2],
                c * v[0] + e * v[1] + f * v[2]]

    def reduce(v):
        return psum((v,), psum_axis)[0]

    b = -(gp - reduce(cam_reduce(mat3vec(hinv, [gl[0], gl[1], gl[2]])))
          ) * freec

    def matvec(x):
        xf = x * freec
        y = reduce(cam_reduce(mat3vec(hinv, lm_reduce(xf))))
        Sx = torch.einsum("cij,cj->ci", Hpp_d, xf) - y
        return Sx * freec + x * fixedc

    # the exact block-tridiagonal preconditioner
    Y_c = _block_mul_sym3(W_c, [c[lmc] for c in hinv])            # (18,C,Kc)
    D = Hpp_d - reduce(_pair_product(Y_c, W_c))
    adj_lm = pcgw.adj_a % L
    Ya = (_block_mul_sym3(Wflat[:, pcgw.adj_a], [c[adj_lm] for c in hinv])
          * pcgw.adj_mask)
    E = -reduce(_pair_product(Ya, Wflat[:, pcgw.adj_b]))          # (C-1,6,6)

    eye6 = torch.eye(6, dtype=dtype, device=device)
    D = D * free[:, None, None] + eye6[None] * (1.0 - free)[:, None, None]
    E = E * free[1:, None, None] * free[:-1, None, None]
    # the tridiagonal truncation of an SPD S need not be SPD; in f32 its
    # factor can meet a negative pivot. A relative diagonal jitter keeps it
    # SPD (it is only the preconditioner: the solution is unaffected)
    jitter = 100.0 * torch.finfo(dtype).eps
    dmean = torch.diagonal(D, dim1=-2, dim2=-1).abs().mean()
    D = D + eye6[None] * (jitter * dmean)
    precond = make_tridiag_precond(D, E)

    dp, _ = pcg(matvec, b, precond, iters=cg_iters, tol=cg_tol)
    t = lm_reduce(dp)
    rhs = [-gl[j] - t[j] for j in range(3)]
    dl = torch.stack(mat3vec(hinv, rhs), dim=1)
    return dp, dl, dpp, dll.T
