"""Plain PyTorch reference of the benchmark's BAL bundle adjustment: the
problem of ``lm_ba.py`` with BAL's 9-parameter camera.

It states the problem the program solves, independently of the program:
pixel residuals d = f (1 + k1 r2 + k2 r2²) x - uv, x = p.xy / p.z,
r2 = |x|², p = R X + t, cost 0.5 sum w |d|^2; cameras moved by
R exp(omega), t + dt, f + df, k1 + dk1, k2 + dk2 (tangent [omega, dt, df,
dk1, dk2]) and points by X + dl; Levenberg-Marquardt with the landmarks
eliminated by the Schur complement, as ``lm_ba.py``:

- Marquardt damping: each diagonal entry of the camera and landmark blocks
  grows by lam times itself (clamped below at 1e-12); a landmark with no
  weight gets the identity block;
- gauge: the fixed cameras' whole 9 x 9 rows and columns of the reduced
  system are identity, their right-hand side zero, so that neither their
  pose nor their intrinsics move;
- the reduced camera system S = Hpp - sum_l W_l Hll^-1 W_l^T is formed by
  dense products, a chunk of landmarks at a time (each chunk's whitened
  block matrix B over its range of cameras), and solved by Cholesky;
  dl = Hll^-1 (-gl - W^T dp);
- Nielsen's control law, as ``lm_ba.solve``.

Where it departs from BAL's text: BAL's cameras look along -z
(x = -p.xy / p.z); here, as in the program, along +z, which a rotation of
pi about z turns one into the other with no other number changed. BAL
fixes no camera; here, as in the program, the configuration's cameras are
fixed, whole, to fix the gauge (a similarity of the scene and the
cameras' poses leaves BAL's cost unchanged).

Every product of matrices is a torch matrix product: computed in float32
with TF32 on, this reference is the control. It imports nothing of the
program and nothing of JAX.
"""

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.lm_ba import _hat, first_camera, so3_exp

# landmarks x cameras x 27 entries of one block of B at a time
CHUNK_ELEMS = 2 ** 24
P = 9


class Problem(NamedTuple):
    cam: torch.Tensor     # (N,) int64, observations with weight > 0,
    lm: torch.Tensor      # (N,) int64  sorted by their landmark's rank
    rank: torch.Tensor    # (N,) int64 the rank of lm in the chunk order
    uv: torch.Tensor      # (N, 2) pixels
    w: torch.Tensor       # (N,)
    fixed: torch.Tensor   # (C,) bool
    n_cams: int
    n_points: int
    chunks: tuple         # (l0, l1, o0, o1, c0, c1) in the rank order


def problem(cam, lm, uv, w, n_cams, n_points, fixed, dtype, device):
    """The reference's own layout of numpy observations, as
    ``lm_ba.problem``'s, with blocks of B 27 entries wide."""
    keep = np.flatnonzero(w > 0)
    cam, lm, uv, w = cam[keep], lm[keep], uv[keep], w[keep]
    first = first_camera(cam, lm, n_points)
    last = np.zeros(n_points, np.int64)
    np.maximum.at(last, lm, cam)
    order = np.argsort(first, kind="stable")
    pos = np.empty(n_points, np.int64)
    pos[order] = np.arange(n_points)
    o = np.argsort(pos[lm], kind="stable")
    cam, lm, uv, w = cam[o], lm[o], uv[o], w[o]
    rank = pos[lm]
    starts = np.searchsorted(rank, np.arange(n_points + 1))
    chunks = []
    l0 = 0
    while l0 < n_points:
        c_lo, c_hi, l1 = first[order[l0]], last[order[l0]], l0 + 1
        while l1 < n_points:
            hi = max(c_hi, last[order[l1]])
            if (l1 + 1 - l0) * 3 * P * (hi - c_lo + 1) > CHUNK_ELEMS:
                break
            c_hi, l1 = hi, l1 + 1
        chunks.append((l0, l1, int(starts[l0]), int(starts[l1]), int(c_lo),
                       int(c_hi) + 1))
        l0 = l1

    def tensor(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    return Problem(tensor(cam), tensor(lm), tensor(rank), tensor(uv, dtype),
                   tensor(w, dtype), tensor(np.asarray(fixed, bool)),
                   int(n_cams), int(n_points), tuple(chunks))


def retract(R, t, K, X, dp, dl):
    return (R @ so3_exp(dp[:, :3]), t + dp[:, 3:6], K + dp[:, 6:],
            X + dl)


def cost(R, t, K, X, P_: Problem):
    """0.5 sum w |d|^2 over the problem's observations."""
    return _residuals(R, t, K, X, P_)[0]


def _residuals(R, t, K, X, P_: Problem):
    Rc = R[P_.cam]
    p = X[P_.lm]
    pc = (Rc @ p[:, :, None])[..., 0] + t[P_.cam]
    iz = 1.0 / pc[:, 2]
    x = pc[:, :2] * iz[:, None]
    r2 = (x * x).sum(-1)
    Kc = K[P_.cam]
    a = 1.0 + r2 * (Kc[:, 1] + Kc[:, 2] * r2)
    d = (Kc[:, 0] * a)[:, None] * x - P_.uv
    return 0.5 * (P_.w * (d * d).sum(-1)).sum(), d, Rc, p, x, iz, r2, a, Kc


def normal_equations(R, t, K, X, P_: Problem):
    """((Hpp (C, 9, 9), gp (C, 9), Hll (L, 3, 3), gl (L, 3), Wo (N, 9, 3)),
    cost), with the observations' rows scaled by sqrt(w)."""
    c, d, Rc, p, x, iz, r2, a, Kc = _residuals(R, t, K, X, P_)
    f, k1, k2 = Kc[:, 0], Kc[:, 1], Kc[:, 2]
    sw = torch.sqrt(P_.w)
    eye2 = torch.eye(2, dtype=R.dtype, device=R.device)
    dudx = ((f * a)[:, None, None] * eye2
            + (2.0 * f * (k1 + 2.0 * k2 * r2))[:, None, None]
            * x[:, :, None] * x[:, None, :])
    z0 = torch.zeros_like(iz)
    dxdp = torch.stack([torch.stack([iz, z0, -x[:, 0] * iz], -1),
                        torch.stack([z0, iz, -x[:, 1] * iz], -1)], -2)
    dudp = dudx @ dxdp                                          # (N, 2, 3)
    Jl = dudp @ Rc
    Jk = torch.stack([a[:, None] * x, (f * r2)[:, None] * x,
                      (f * r2 * r2)[:, None] * x], -1)         # (N, 2, 3)
    Jp = torch.cat([-(Jl @ _hat(p)), dudp, Jk], -1) * sw[:, None, None]
    Jl = Jl * sw[:, None, None]
    r = d * sw[:, None]
    C, L = P_.n_cams, P_.n_points
    dtype, device = R.dtype, R.device
    Hpp = torch.zeros((C, P, P), dtype=dtype, device=device).index_add_(
        0, P_.cam, Jp.mT @ Jp)
    gp = torch.zeros((C, P), dtype=dtype, device=device).index_add_(
        0, P_.cam, (Jp.mT @ r[:, :, None])[..., 0])
    Hll = torch.zeros((L, 3, 3), dtype=dtype, device=device).index_add_(
        0, P_.lm, Jl.mT @ Jl)
    gl = torch.zeros((L, 3), dtype=dtype, device=device).index_add_(
        0, P_.lm, (Jl.mT @ r[:, :, None])[..., 0])
    Wo = Jp.mT @ Jl
    return (Hpp, gp, Hll, gl, Wo), c


def reduced_system(H, lam, P_: Problem):
    """The damped, gauge-fixed reduced camera system: (S (9C, 9C),
    b (9C,), Hinv (L, 3, 3), dpp (C, 9), dll (L, 3))."""
    Hpp, gp, Hll, gl, Wo = H
    C, L = P_.n_cams, P_.n_points
    dtype, device = gp.dtype, gp.device
    dpp = torch.clamp_min(torch.diagonal(Hpp, dim1=-2, dim2=-1), 1e-12)
    dll = torch.clamp_min(torch.diagonal(Hll, dim1=-2, dim2=-1), 1e-12)
    empty = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1) <= 0
    eye3 = torch.eye(3, dtype=dtype, device=device)
    Hll_d = torch.where(empty[:, None, None], eye3,
                        Hll + torch.diag_embed(lam * dll))
    Lc = torch.linalg.cholesky(Hll_d)
    Hinv = torch.cholesky_inverse(Lc)
    Xo = torch.linalg.solve_triangular(Lc[P_.lm], Wo.mT,
                                       upper=False)          # (N, 3, 9)

    S = torch.zeros((P * C, P * C), dtype=dtype, device=device)
    for l0, l1, o0, o1, c0, c1 in P_.chunks:
        nl, nc = l1 - l0, c1 - c0
        Bc = torch.zeros((nl, nc, 3, P), dtype=dtype, device=device)
        Bc.index_put_((P_.rank[o0:o1] - l0, P_.cam[o0:o1] - c0), Xo[o0:o1],
                      accumulate=True)
        B2 = Bc.permute(0, 2, 1, 3).reshape(3 * nl, P * nc)
        S[P * c0:P * c1, P * c0:P * c1] -= B2.T @ B2
    ci = torch.arange(C, device=device)
    S4 = S.view(C, P, C, P)
    S4[ci, :, ci, :] += Hpp + torch.diag_embed(lam * dpp)

    u = (Hinv @ gl[:, :, None])[..., 0]
    y = torch.zeros((C, P), dtype=dtype, device=device).index_add_(
        0, P_.cam, (Wo @ u[P_.lm][:, :, None])[..., 0])
    b = -(gp - y)
    free = (~P_.fixed).to(dtype)
    S4 *= free[:, None, None, None] * free[None, None, :, None]
    S4[ci, :, ci, :] += (1.0 - free)[:, None, None] * torch.eye(
        P, dtype=dtype, device=device)
    return S, (b * free[:, None]).reshape(-1), Hinv, dpp, dll


def damped_step(H, lam, P_: Problem):
    """The damped, gauge-fixed Gauss-Newton step: (dp (C, 9), dl (L, 3),
    Marquardt diagonals dpp (C, 9), dll (L, 3))."""
    gl, Wo = H[3], H[4]
    C, L = P_.n_cams, P_.n_points
    S, b, Hinv, dpp, dll = reduced_system(H, lam, P_)
    dtype, device = b.dtype, b.device
    Ls, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        return (torch.full((C, P), torch.nan, dtype=dtype, device=device),
                torch.full((L, 3), torch.nan, dtype=dtype, device=device),
                dpp, dll)
    dp = torch.cholesky_solve(b.reshape(-1, 1), Ls).reshape(C, P)
    tl = torch.zeros((L, 3), dtype=dtype, device=device).index_add_(
        0, P_.lm, (Wo.mT @ dp[P_.cam][:, :, None])[..., 0])
    dl = (Hinv @ (-gl - tl)[:, :, None])[..., 0]
    return dp, dl, dpp, dll


class State(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    K: torch.Tensor   # (C, 3) [f, k1, k2]
    X: torch.Tensor
    costs: list       # floats: the start's cost, then after each step
    it: int


def solve(R, t, K, X, P_: Problem, iters, lambda_init=1e-4, xtol=1e-12):
    """`iters` LM steps (fewer where an accepted step is shorter than
    xtol) from (R, t, K, X)."""
    H, c = normal_equations(R, t, K, X, P_)
    c = float(c)
    lam, nu = lambda_init, 2.0
    costs = [c]
    it = 0
    while it < iters:
        dp, dl, dpp, dll = damped_step(H, lam, P_)
        bad = not bool(torch.isfinite(dp).all() & torch.isfinite(dl).all())
        if bad:
            dp, dl = torch.zeros_like(dp), torch.zeros_like(dl)
        R1, t1, K1, X1 = retract(R, t, K, X, dp, dl)
        H1, c1 = normal_equations(R1, t1, K1, X1, P_)
        c1 = float(c1)
        gp, gl = H[1], H[3]
        pred = 0.5 * float((dp * (lam * dpp * dp - gp)).sum()
                           + (dl * (lam * dll * dl - gl)).sum())
        rho = (c - c1) / max(pred, 1e-30)
        accept = c1 < c and np.isfinite(c1) and not bad
        if accept:
            lam = lam * max(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
            nu = 2.0
        else:
            lam, nu = lam * nu, nu * 2.0
        lam = min(max(lam, 1e-12), 1e10)
        step_sq = float((dp * dp).sum() + (dl * dl).sum())
        if accept:
            R, t, K, X, H, c = R1, t1, K1, X1, H1, c1
        costs.append(c)
        it += 1
        if accept and step_sq < xtol * xtol:
            break
    return State(R, t, K, X, costs, it)
