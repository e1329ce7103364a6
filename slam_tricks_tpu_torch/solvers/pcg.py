"""Matrix-free preconditioned conjugate gradients on the Schur reduced camera
system over an observation list (port of ``slam_tricks_tpu/solvers/pcg.py``).

S x = b with S = Hpp_d - W Hll_d^-1 Wᵀ is never formed: one product S x
gathers x per observation, sums Wᵀ x per landmark, applies Hll_d^-1 and
sums W u per camera, in the fixed orders of ``schur.obs_tables``. The
preconditioner is block-Jacobi on the damped pose blocks, or, with
``band_pairs``, the block-tridiagonal part of S factored by the stored
block-Cholesky factor of ``banded_flat`` (``make_tridiag_precond``).
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.ops.smallchol import (cholesky_small,
                                                 solve_lower_small,
                                                 solve_lower_t_small)
from slam_tricks_tpu_torch.solvers.banded_flat import (block_tridiag_factor,
                                                       tridiag_backward,
                                                       tridiag_forward)
from slam_tricks_tpu_torch.solvers.common import sum_table, table_sum
from slam_tricks_tpu_torch.solvers.schur import (_back_substitute,
                                                 _damp_blocks, _damp_hll,
                                                 _inv3x3, _rhs, obs_tables)

CHECK_EVERY = 8     # CG iterations between two reads of the stop flag


class BandPairs(NamedTuple):
    """The within-track observation pairs on S's block diagonal (diag_*:
    cam(a) == cam(b), unordered, w = 0.5 on a == b so that M + Mᵀ counts
    them once) and first sub-diagonal (super_*: cam(a) == cam(b) + 1, the
    exact blocks S[c + 1, c]). Observation indices, as the JAX package
    lays them out."""
    diag_a: torch.Tensor
    diag_b: torch.Tensor
    diag_w: torch.Tensor
    super_a: torch.Tensor
    super_b: torch.Tensor
    super_w: torch.Tensor


def build_band_pairs(cam_idx, lm_idx, dtype=torch.float32, device=None):
    """The BandPairs of an observation list, host side in numpy, track by
    track; on the observations' device (a tensor's own, else `device`, the
    card unless the caller names another)."""
    if device is None and isinstance(cam_idx, torch.Tensor):
        device = cam_idx.device
    device = resolve(device)
    host = lambda a: np.asarray(a.cpu() if isinstance(a, torch.Tensor)  # noqa: E731
                                else a)
    cam_idx, lm_idx = host(cam_idx), host(lm_idx)
    order = np.argsort(lm_idx, kind="stable").astype(np.int32)
    lm_sorted = lm_idx[order]
    starts = np.flatnonzero(np.r_[True, lm_sorted[1:] != lm_sorted[:-1]])
    ends = np.r_[starts[1:], lm_sorted.shape[0]]
    da, db, sa, sb = [], [], [], []
    for s, e in zip(starts, ends):
        idx = order[s:e]
        cams = cam_idx[idx]
        ii, jj = np.triu_indices(e - s)
        ca, cb = cams[ii], cams[jj]
        same = ca == cb
        da.append(idx[ii][same])
        db.append(idx[jj][same])
        up = ca == cb + 1
        sa.append(idx[ii][up])
        sb.append(idx[jj][up])
        dn = cb == ca + 1
        sa.append(idx[jj][dn])
        sb.append(idx[ii][dn])
    cat = lambda lst: (np.concatenate(lst) if lst  # noqa: E731
                       else np.zeros(0, np.int32))
    da, db, sa, sb = cat(da), cat(db), cat(sa), cat(sb)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    dw = np.where(da == db, 0.5, 1.0).astype(np_dtype)
    # at least one (zero-weight) entry each, as the JAX package keeps
    if da.size == 0:
        da = db = np.zeros(1, np.int32)
        dw = np.zeros(1, np_dtype)
    if sa.size == 0:
        sa = sb = np.zeros(1, np.int32)
        sw = np.zeros(1, np_dtype)
    else:
        sw = np.ones(sa.shape[0], np_dtype)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return BandPairs(diag_a=t(da), diag_b=t(db), diag_w=t(dw),
                     super_a=t(sa), super_b=t(sb), super_w=t(sw))


def band_tables(bp: BandPairs, cam_idx, n_cams):
    """The fixed summation orders of ``assemble_tridiag``: the diagonal
    pairs by cam(a), the sub-diagonal pairs by cam(b); built once a
    problem."""
    cam = cam_idx.long()
    return (sum_table(cam[bp.diag_a.long()], n_cams),
            sum_table(cam[bp.super_b.long()], n_cams))


def make_tridiag_precond(D, E):
    """The block-tridiagonal preconditioner M = tridiag(S): D (C, 6, 6) the
    diagonal blocks, E (C-1, 6, 6) the sub-diagonal blocks S[c + 1, c].
    It is ``banded_flat``'s stored factor at G = C blocks of m = 6 (its
    conventions are the JAX package's: E[g] at (g + 1, g), lower factor,
    F = E L^-T), applied by its two substitutions, each an associative
    scan of batched products. Returns precond(r (C, 6)) -> M^-1 r."""
    fac = block_tridiag_factor(D, E)
    return lambda r: tridiag_backward(fac, tridiag_forward(fac, r))


def assemble_tridiag(Hpp_d, Hll_inv, W_obs, cam_idx, lm_idx, free,
                     band_pairs: BandPairs, tables=None):
    """The damped, gauge-fixed diagonal and sub-diagonal blocks of S from
    the band pairs (exact blocks, O(band pairs) work), summed in the
    orders of ``band_tables`` (built here when None). Returns (D (C, 6, 6),
    E (C-1, 6, 6))."""
    dtype = Hpp_d.dtype
    C = Hpp_d.shape[0]
    cam, lm = cam_idx.long(), lm_idx.long()
    if tables is None:
        tables = band_tables(band_pairs, cam_idx, C)
    Y = torch.einsum("nij,njk->nik", W_obs, Hll_inv[lm])

    def pair_sum(a, b, w, table):
        a, b = a.long(), b.long()
        blk = (torch.einsum("pim,pjm->pij", Y[a], W_obs[b])
               * w.to(dtype)[:, None, None])
        return table_sum(blk.reshape(-1, 36).T, table).reshape(C, 6, 6)

    M = pair_sum(band_pairs.diag_a, band_pairs.diag_b, band_pairs.diag_w,
                 tables[0])
    D = Hpp_d - (M + M.mT)
    E = -pair_sum(band_pairs.super_a, band_pairs.super_b, band_pairs.super_w,
                  tables[1])[:-1]

    eye6 = torch.eye(6, dtype=dtype, device=Hpp_d.device)
    D = D * free[:, None, None] + eye6[None] * (1.0 - free)[:, None, None]
    E = E * free[1:, None, None] * free[:-1, None, None]
    return D, E


def make_schur_matvec(Hpp_d, Hll_inv, W_obs, cam_idx, lm_idx, n_points,
                      tables=None):
    """matvec(x (C, 6)) -> S x (C, 6), matrix-free."""
    C = Hpp_d.shape[0]
    if tables is None:
        tables = obs_tables(cam_idx, lm_idx, C, n_points)
    cam, lm = cam_idx.long(), lm_idx.long()

    def matvec(x):
        t = table_sum(torch.einsum("nij,ni->jn", W_obs, x[cam]), tables.lm)
        u = torch.einsum("lij,lj->li", Hll_inv, t)
        y = table_sum(torch.einsum("nij,nj->in", W_obs, u[lm]), tables.cam)
        return torch.einsum("cij,cj->ci", Hpp_d, x) - y

    return matvec


def pcg(matvec, b, precond, *, iters=100, tol=1e-10,
        check_every=CHECK_EVERY):
    """Preconditioned CG from x = 0 for at most `iters` iterations, done
    once ‖r‖ < tol ‖b‖ (or at once when ‖b‖ < tol), as the JAX package's
    ``while_loop``. Here the loop runs on the host: once done, every
    update is frozen (the iterations after it change nothing), and the flag
    is read every `check_every` iterations, not every one. Returns (x, the
    iterations that updated x, a device scalar)."""
    b_norm = torch.sqrt(torch.sum(b * b))
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    done = b_norm < tol
    for i in range(iters):
        if i % check_every == 0 and bool(done):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = precond(r_n)
        rz_n = torch.sum(r_n * z_n)
        beta = rz_n / torch.clamp_min(rz, 1e-30)
        p_n = z_n + beta * p
        done_n = (torch.sqrt(torch.sum(r_n * r_n))
                  < tol * torch.clamp_min(b_norm, 1e-30))
        x, r, z, p, rz = (torch.where(done, old, new) for old, new in
                          ((x, x_n), (r, r_n), (z, z_n), (p, p_n),
                           (rz, rz_n)))
        it = it + (~done).to(it.dtype)
        done = done | done_n
    return x, it


def solve_rcs_pcg(Hpp, Hll, gp, gl, W_obs, cam_idx, lm_idx, lam, fixed_mask,
                  n_points, *, cg_iters=100, cg_tol=1e-8, band_pairs=None,
                  tables=None, band_tables=None):
    """Solve the damped reduced camera system by PCG and back-substitute the
    landmarks: the matrix-free counterpart of ``schur._schur_reduce``.
    Block-Jacobi on the damped pose blocks by default; with
    `band_pairs=build_band_pairs(cam_idx, lm_idx)` the exact
    block-tridiagonal preconditioner. `tables` (``schur.obs_tables``) and
    `band_tables` (``band_tables``) are built here when None. Returns
    (dp (C, 6), dl (L, 3))."""
    dtype = gp.dtype
    C = gp.shape[0]
    cam, lm = cam_idx.long(), lm_idx.long()
    if tables is None:
        tables = obs_tables(cam_idx, lm_idx, C, n_points)
    Hpp_d = _damp_blocks(Hpp, lam)
    Hll_inv = _inv3x3(_damp_hll(Hll, lam))

    free = (~fixed_mask).to(dtype)
    fixed = fixed_mask.to(dtype)
    b = _rhs(gp, gl, W_obs, Hll_inv, lm, tables.cam) * free[:, None]
    base_matvec = make_schur_matvec(Hpp_d, Hll_inv, W_obs, cam_idx, lm_idx,
                                    n_points, tables)

    def matvec(x):
        # the gauge: S on the free cameras, the identity on the fixed ones
        return (base_matvec(x * free[:, None]) * free[:, None]
                + x * fixed[:, None])

    if band_pairs is not None:
        D, E = assemble_tridiag(Hpp_d, Hll_inv, W_obs, cam_idx, lm_idx, free,
                                band_pairs, band_tables)
        precond = make_tridiag_precond(D, E)
    else:
        eye6 = torch.eye(6, dtype=dtype, device=gp.device)
        Lm = cholesky_small(Hpp_d * free[:, None, None]
                            + eye6[None] * fixed[:, None, None])

        def precond(r):
            y = solve_lower_small(Lm, r[..., None])
            return solve_lower_t_small(Lm, y)[..., 0]

    dp, _ = pcg(matvec, b, precond, iters=cg_iters, tol=cg_tol)
    return dp, _back_substitute(dp, W_obs, Hll_inv, gl, cam, tables.lm)
