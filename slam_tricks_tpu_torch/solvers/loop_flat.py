"""Loop-closure large-C BA: the banded factor with an exact low-rank
Woodbury correction (port of ``slam_tricks_tpu/solvers/loop_flat.py``).

A landmark whose track spans more than the band (a loop closure: seen at
the start of the trajectory and again when the camera returns) couples
cameras far apart, which the banded layout cannot hold. The reduced camera
system splits as

    S = S_sb - U Uᵀ,

S_sb the banded system of the single-run landmarks (the camera blocks of
every landmark, minus the single-run downdates: ``banded_flat``), and U
the column-stacked W_l Hll_l^-T/2 of the loop-closure landmarks, nonzero
only on the rows of A, the cameras of any loop-closure track. When
3 M > 6 |A| the factor is compressed through its support by an LQ
decomposition (the R of a QR of U_Aᵀ), width min(3 M, 6 |A|). With
S_sb = Lt Ltᵀ the stored factor and Ut = Lt^-1 U,

    S^-1 b = Lt^-T [c + Ut (I - UtᵀUt)^-1 Utᵀ c],   c = Lt^-1 b,

one multi-right-hand-side forward substitution of [b | U] and a q x q
capacitance solved by ``eigh`` with its eigenvalues clipped at
1e3 eps(dtype).

On the card the single-run part's linearize + assemble runs the
``ba_assemble`` kernel, as path B does; the loop-closure part is a few
thousand slots of plain torch. Camera state reaches a loop-closure slot
through the one-hot (pA, C) support rows and a gather; its sums onto A are
one-hot matrix products, so every sum runs in a fixed order. The LM loop
carries the single-run points (slot order) and the loop-closure points
(in that order) as one concatenated (Lpad + Mpad, 3) tensor; the returned
points are in the original landmark order.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.ops.ba_assemble import slot_columns
from slam_tricks_tpu_torch.residuals import robust
from slam_tricks_tpu_torch.sim.ba_scene import BAObservations
from slam_tricks_tpu_torch.solvers.banded_flat import (
    BandedWork, _assemble_bands, _backsub, _banded_quantities,
    _cam_rhs, _group_superblocks, _mat3vec, _takahashi_inverse_blocks,
    block_tridiag_factor, build_banded_work, scatter_slots,
    tridiag_backward, tridiag_forward)
from slam_tricks_tpu_torch.solvers.common import (first_camera_fixed, psum,
                                                  set_full_precision)
from slam_tricks_tpu_torch.solvers.schur import lm_loop
from slam_tricks_tpu_torch.solvers.schur_flat_sm import (_chol3_flat,
                                                         _inv3x3_flat,
                                                         damp_hll)


class LoopWork(NamedTuple):
    """Host-built structure: the banded layout of the single-run landmarks
    and the slot grid of the loop-closure landmarks on their camera
    support A, on the observations' device."""
    banded: BandedWork        # single-run landmarks
    lc_uv0: torch.Tensor      # (Klc, Mpad) measured u
    lc_uv1: torch.Tensor      # (Klc, Mpad) measured v
    lc_w: torch.Tensor        # (Klc, Mpad) weights, 0 = no observation
    lc_aslot: torch.Tensor    # (Klc, Mpad) int64 the slot camera's row in A
    lc_lm: torch.Tensor       # (Mpad,) int64 landmark id, n_points = padding
    lc_gather: torch.Tensor   # (Mpad,) int64 lc_lm clipped to [0, L)
    onehot_A: torch.Tensor    # (pA, C) one-hot rows of the support cameras,
    #                           zero rows past the real support


def build_loop_work(obs, n_cams, n_points, dtype=torch.float32, chunk=32,
                    max_band=32):
    """Split the landmarks by the camera span of their track: a span of at
    most max_band goes to the banded layout, a longer one (a loop closure)
    to the slot grid on the support A. Numpy on the host, the JAX
    package's layout. Raises ValueError for a duplicate (landmark, camera)
    observation."""
    device = obs.uv.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cam = obs.cam_idx.cpu().numpy().astype(np.int64)
    lm = obs.lm_idx.cpu().numpy().astype(np.int64)
    uv = obs.uv.cpu().numpy()
    w = obs.weight.cpu().numpy()
    C, L = int(n_cams), int(n_points)
    valid = np.flatnonzero(w > 0)
    cam_v, lm_v = cam[valid], lm[valid]
    key = lm_v * C + cam_v
    if np.unique(key).shape[0] != key.shape[0]:
        raise ValueError("duplicate (landmark, camera) observation")

    c0 = np.full(L, C, np.int64)
    cmax = np.full(L, -1, np.int64)
    np.minimum.at(c0, lm_v, cam_v)
    np.maximum.at(cmax, lm_v, cam_v)
    observed = cmax >= 0
    span = np.where(observed, cmax - c0 + 1, 1)
    is_lc = observed & (span > max_band)
    sr_sel = valid[~is_lc[lm_v]]
    lc_sel = valid[is_lc[lm_v]]

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    sr_obs = BAObservations(
        cam_idx=tensor(cam[sr_sel].astype(np.int32)),
        lm_idx=tensor(lm[sr_sel].astype(np.int32)),
        uv=tensor(uv[sr_sel].astype(np_dtype)),
        weight=tensor(w[sr_sel].astype(np_dtype)))
    banded = build_banded_work(sr_obs, C, L, dtype=dtype, chunk=chunk,
                               max_band=max_band)

    # the loop-closure grid: slot k of loop landmark m is its k-th
    # observation in camera order
    lc_lms = np.flatnonzero(is_lc)
    M = lc_lms.size
    Mpad = max(M + (-M) % 8, 8)
    counts = (np.bincount(lm[lc_sel], minlength=L)[lc_lms] if M
              else np.zeros(0, np.int64))
    Klc = max(int(counts.max()) if M else 1, 1)
    A = np.unique(cam[lc_sel]) if M else np.zeros(0, np.int64)
    pA_real = A.size
    pA = max(pA_real + (-pA_real) % 8, 8)
    a_of_cam = np.zeros(C, np.int64)
    a_of_cam[A] = np.arange(pA_real)

    uvg = np.zeros((Klc, 2, Mpad), np_dtype)
    wg = np.zeros((Klc, Mpad), np_dtype)
    aslot = np.zeros((Klc, Mpad), np.int64)
    lc_of = np.full(L, Mpad, np.int64)
    lc_of[lc_lms] = np.arange(M)
    if M:
        order = lc_sel[np.lexsort((cam[lc_sel], lm[lc_sel]))]
        col = lc_of[lm[order]]
        starts = np.zeros(M + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(order.size) - starts[col]
        uvg[slot, 0, col] = uv[order, 0].astype(np_dtype)
        uvg[slot, 1, col] = uv[order, 1].astype(np_dtype)
        wg[slot, col] = w[order].astype(np_dtype)
        aslot[slot, col] = a_of_cam[cam[order]]

    onehot_A = np.zeros((pA, C), np_dtype)
    onehot_A[np.arange(pA_real), A] = 1
    lc_lm = np.full(Mpad, L, np.int64)
    lc_lm[:M] = lc_lms
    return LoopWork(
        banded=banded, lc_uv0=tensor(uvg[:, 0]), lc_uv1=tensor(uvg[:, 1]),
        lc_w=tensor(wg), lc_aslot=tensor(aslot), lc_lm=tensor(lc_lm),
        lc_gather=tensor(np.minimum(lc_lm, L - 1)),
        onehot_A=tensor(onehot_A))


def _onehot_slots(lw: LoopWork, dtype):
    """(Klc, Mpad, pA) one-hot of each loop-closure slot's row in A."""
    return torch.nn.functional.one_hot(
        lw.lc_aslot, lw.onehot_A.shape[0]).to(dtype)


def _lc_quantities(poses, points_lc, lw: LoopWork, loss=None):
    """Linearize the loop-closure slots (plain torch): camera state through
    the support rows RA = onehot_A [R | t] and a gather by lc_aslot, the
    camera sums onto A and then C by one-hot products. Returns (cam_red
    (C, 28): 21 Hpp | 6 gp | 1 cost, Hll (6, Mpad), gl (3, Mpad),
    W (18, Klc, Mpad))."""
    C = lw.banded.n_cams
    R12 = torch.cat([poses.R.reshape(C, 9), poses.t], dim=1)
    RA = lw.onehot_A @ R12                                        # (pA, 12)
    cols, lm_red, W = slot_columns(RA[:, :9], RA[:, 9:], points_lc,
                                   lw.lc_uv0, lw.lc_uv1, lw.lc_w,
                                   lw.lc_aslot, loss)
    camA = torch.einsum("kma,nkm->an", _onehot_slots(lw, points_lc.dtype),
                        cols)                                     # (pA, 28)
    return lw.onehot_A.T @ camA, lm_red[:6], lm_red[6:], W


def _lc_factor(W_lc, Hd_lc, lw: LoopWork, freeA):
    """U_A (pA, 6, q): the loop-closure downdate factor on its support,
    zero at fixed cameras; q = min(3 Mpad, 6 pA), compressed by the R of a
    QR of U_Aᵀ when 3 Mpad is wider (U Uᵀ is the Gram of a nearby factor,
    which keeps S = S_sb - U Uᵀ positive definite in float32). R's row signs
    are LAPACK's: hold U Uᵀ, not U, against another implementation."""
    Klc, Mpad = lw.lc_w.shape
    pA = lw.onehot_A.shape[0]
    # whiten: Y_k = W_k L^-T per slot (forward substitution in columns)
    l00, l10, l11, l20, l21, l22 = _chol3_flat(Hd_lc)
    i00, i11, i22 = 1.0 / l00, 1.0 / l11, 1.0 / l22
    W3 = W_lc.view(6, 3, Klc, Mpad)
    y0 = W3[:, 0] * i00
    y1 = (W3[:, 1] - l10 * y0) * i11
    y2 = (W3[:, 2] - l20 * y0 - l21 * y1) * i22
    Y = torch.stack([y0, y1, y2], dim=1)                     # (6, 3, Klc, Mpad)
    Ua = torch.einsum("kma,ijkm->aimj", _onehot_slots(lw, W_lc.dtype), Y)
    Ua = (Ua * freeA[:, None, None, None]).reshape(pA, 6, 3 * Mpad)
    if 3 * Mpad <= 6 * pA:
        return Ua
    Rq = torch.linalg.qr(Ua.reshape(pA * 6, 3 * Mpad).T, mode="r").R
    return Rq.T.reshape(pA, 6, 6 * pA)


def _capacitance_inverse(Ut):
    """(Vc, w_inv): cap = I - UtᵀUt (eigenvalues in (0, 1] in exact
    arithmetic) as Vc diag(1 / max(w, 1e3 eps)) Vcᵀ. A NaN in Ut (a factor
    that failed) stays in the step, which the LM loop then rejects: eigh
    is given the identity in its place."""
    q = Ut.shape[-1]
    dtype = Ut.dtype
    eye = torch.eye(q, dtype=dtype, device=Ut.device)
    cap = eye - torch.einsum("gmq,gmr->qr", Ut, Ut)
    cap = 0.5 * (cap + cap.T)
    cap = torch.where(torch.isfinite(cap).all(), cap, eye)
    wc, Vc = torch.linalg.eigh(cap)
    tol = 1e3 * torch.finfo(dtype).eps
    return Vc, 1.0 / torch.clamp_min(wc, tol)


def _solve_loop(Hpp, gp, Hll_sr, gl_sr, W_sr, Hll_lc, gl_lc, W_lc, lam,
                fixed_mask, lw: LoopWork, psum_axis=None):
    """The exact damped, gauge-fixed solve of the whole reduced camera
    system: the stored factor of S_sb, one forward substitution of [b | U],
    the Woodbury capacitance, one backward substitution; then both
    landmark back-substitutions. Returns (dp (C, 6), dl_sr (Lpad, 3),
    dl_lc (Mpad, 3), diag_pp (C, 6), diag_sr (Lpad, 3), diag_lc (Mpad, 3)).

    psum_axis: a process group whose ranks each hold a slice of the
    single-run chunks (``parallel/loop_dist``): the band downdates and the
    single-run part of the rhs are summed over the ranks; the loop-closure
    part, which every rank holds whole, is added after the sums, and the
    factor, the capacitance and the substitutions are replicated."""
    bw = lw.banded
    C = bw.n_cams
    Klc, Mpad = lw.lc_w.shape
    bands, hinv_sr, dpp, dll_sr, free = _assemble_bands(
        Hpp, Hll_sr, W_sr, lam, fixed_mask, bw, psum_axis)

    Hd_lc, dll_lc = damp_hll(Hll_lc, lam)
    hinv_lc = torch.stack(_inv3x3_flat(Hd_lc))
    freeA = lw.onehot_A @ free
    Ua = _lc_factor(W_lc, Hd_lc, lw, freeA)                     # (pA, 6, q)
    q = Ua.shape[-1]

    # rhs: b = -(gp - W Hll^-1 gl), the camera sums of both parts
    W3 = W_lc.view(6, 3, Klc, Mpad)
    u_lc = _mat3vec(hinv_lc, gl_lc)
    cols = W3[:, 0] * u_lc[0] + W3[:, 1] * u_lc[1] + W3[:, 2] * u_lc[2]
    yA = torch.einsum("kma,ikm->ai", _onehot_slots(lw, gp.dtype), cols)
    y = (psum((_cam_rhs(W_sr, hinv_sr, gl_sr, bw),), psum_axis)[0]
         + lw.onehot_A.T @ yA)
    b = -(gp - y) * free[:, None]

    Dm, Em, Kb = _group_superblocks(bands, C)
    G, m = Dm.shape[0], Dm.shape[1]
    R = gp.new_zeros((G * Kb, 6, 1 + q))
    R[:C, :, 0] = b
    R[:C, :, 1:] = torch.einsum("ac,aiq->ciq", lw.onehot_A, Ua)
    fac = block_tridiag_factor(Dm, Em)
    Y = tridiag_forward(fac, R.view(G, m, 1 + q))
    c, Ut = Y[..., 0], Y[..., 1:]
    Vc, w_inv = _capacitance_inverse(Ut)
    z = Vc @ (w_inv * (Vc.T @ torch.einsum("gmq,gm->q", Ut, c)))
    dp = tridiag_backward(fac, c + torch.einsum("gmq,q->gm", Ut, z))
    dp = dp.reshape(G * Kb, 6)[:C]

    dl_sr = _backsub(dp, free, W_sr, hinv_sr, gl_sr, bw)
    dpk = (lw.onehot_A @ (dp * free[:, None]))[lw.lc_aslot]  # (Klc, Mpad, 6)
    t = (W3 * dpk.permute(2, 0, 1)[:, None]).sum(dim=(0, 2))   # (3, Mpad)
    dl_lc = _mat3vec(hinv_lc, -gl_lc - t).T
    return dp, dl_sr, dl_lc, dpp, dll_sr.T, dll_lc.T


def solve_ba_loop(poses0, points0, lw: LoopWork, *, fixed_mask=None,
                  max_iters=30, lambda_init=1e-4, xtol=1e-12, loss=None,
                  costs=None, psum_axis=None, raw_points=False):
    """LM bundle adjustment with loop closures, an exact linear solve every
    step; the same iteration trajectory as the JAX package's
    ``solve_ba_loop``. points0 (L, 3) in the original landmark order, as
    are the returned state's points; fixed_mask (C,) bool (default: camera
    0); lambda_init, xtol, loss and costs as in
    ``banded_flat.solve_ba_banded``. Returns a BAState.

    psum_axis: a ``torch.distributed`` process group whose ranks each run
    this solve with their own slice of the single-run chunks in
    `lw.banded` and the whole loop-closure grid (``parallel/loop_dist``):
    the single-run camera sums and scalars are summed over the ranks, the
    loop-closure terms, alike on every rank, are added after the sums.
    None: one process, no collective. raw_points=True returns the points
    as the pair (single-run points in the slice's slot order (Lpad, 3),
    loop-closure points (Mpad, 3)), not scattered to the landmark order."""
    robust.check(loss)
    set_full_precision()
    bw = lw.banded
    n_sr = bw.w.shape[1]
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(bw.n_cams, points0.device)

    def quantities(poses, points):
        (Hpp, gp, Hll_sr, gl_sr, W_sr), cost = _banded_quantities(
            poses, points[:n_sr], bw, loss, psum_axis)
        cam_lc, Hll_lc, gl_lc, W_lc = _lc_quantities(poses, points[n_sr:],
                                                     lw, loss)
        blocks = (Hpp + cam_lc[:, :21], gp + cam_lc[:, 21:27], Hll_sr,
                  torch.cat([gl_sr, gl_lc], dim=1), W_sr, Hll_lc, W_lc)
        return blocks, cost + cam_lc[:, 27].sum()

    def solve(blocks, lam):
        Hpp, gp, Hll_sr, gl, W_sr, Hll_lc, W_lc = blocks
        dp, dl_sr, dl_lc, dpp, d_sr, d_lc = _solve_loop(
            Hpp, gp, Hll_sr, gl[:, :n_sr], W_sr, Hll_lc, gl[:, n_sr:], W_lc,
            lam, fixed_mask, lw, psum_axis)
        return dp, torch.cat([dl_sr, dl_lc]), dpp, torch.cat([d_sr, d_lc])

    points_s0 = torch.cat([points0[bw.gather_idx], points0[lw.lc_gather]])
    final = lm_loop(poses0, points_s0, quantities, solve, max_iters=max_iters,
                    lambda_init=lambda_init, xtol=xtol, costs=costs,
                    psum_axis=psum_axis, n_local=n_sr)
    if raw_points:
        return final._replace(points=(final.points[:n_sr],
                                      final.points[n_sr:]))
    points = scatter_slots(points0, final.points[:n_sr], bw.scatter_idx)
    points = scatter_slots(points, final.points[n_sr:], lw.lc_lm)
    return final._replace(points=points)


def loop_pose_covariances(poses, points, lw: LoopWork, fixed_mask, *,
                          lam=0.0, loss=None):
    """Marginal 6x6 pose covariances (C, 6, 6) at the solution of a
    loop-closure problem: S^-1 = S_sb^-1 + Z cap^-1 Zᵀ with Z = Lt^-T Ut,
    so each camera's block is the banded Takahashi diagonal plus a rank-q
    correction (with the solver's eigenvalue clip). Fixed cameras get zero.
    `points` in the original landmark order."""
    robust.check(loss)
    bw = lw.banded
    C = bw.n_cams
    dtype, device = points.dtype, points.device
    lam = torch.tensor(lam, dtype=dtype, device=device)
    (Hpp, _, Hll_sr, _, W_sr), _ = _banded_quantities(
        poses, points[bw.gather_idx], bw, loss)
    cam_lc, Hll_lc, _, W_lc = _lc_quantities(poses, points[lw.lc_gather], lw,
                                             loss)
    bands, _, _, _, free = _assemble_bands(Hpp + cam_lc[:, :21], Hll_sr,
                                           W_sr, lam, fixed_mask, bw)
    Hd_lc, _ = damp_hll(Hll_lc, lam)
    Ua = _lc_factor(W_lc, Hd_lc, lw, lw.onehot_A @ free)
    q = Ua.shape[-1]
    Dm, Em, Kb = _group_superblocks(bands, C)
    G, m = Dm.shape[0], Dm.shape[1]
    Cp = G * Kb
    U = points.new_zeros((Cp, 6, q))
    U[:C] = torch.einsum("ac,aiq->ciq", lw.onehot_A, Ua)
    fac = block_tridiag_factor(Dm, Em)
    Ut = tridiag_forward(fac, U.view(G, m, q))
    Vc, w_inv = _capacitance_inverse(Ut)
    Z = tridiag_backward(fac, Ut)                          # Lt^-T Ut
    Zc = (Z @ (Vc * torch.sqrt(w_inv)[None, :])).reshape(Cp, 6, q)
    corr = (Zc @ Zc.mT)[:C]
    P, _ = _takahashi_inverse_blocks(Dm, Em, G)
    r = torch.arange(Kb, device=device)
    base = P.reshape(G, Kb, 6, Kb, 6)[:, r, :, r, :].transpose(0, 1)
    base = base.reshape(Cp, 6, 6)[:C]
    return (base + corr) * free[:, None, None]
