"""Plain PyTorch reference of the benchmark's bundle adjustment.

It states the problem the program solves, independently of the program:
pinhole residuals d = (x / z, y / z) - uv of p = R X + t, cost 0.5 sum
w |d|^2, poses moved by R exp(omega), t + dt (tangent [omega, dt]) and
points by X + dl, and Levenberg-Marquardt with the landmarks eliminated by
the Schur complement:

- Marquardt damping: each diagonal entry of the camera and landmark blocks
  grows by lam times itself (clamped below at 1e-12); a landmark with no
  weight gets the identity block;
- gauge: the fixed cameras' rows and columns of the reduced system are
  identity, their right-hand side zero;
- the reduced camera system S = Hpp - sum_l W_l Hll^-1 W_l^T is formed
  densely and solved by Cholesky; dl = Hll^-1 (-gl - W^T dp);
- Nielsen's control law: a step is taken where it lowers the cost, lam
  then scales by max(1 - (2 rho - 1)^3, 1/3), and otherwise by nu, which
  doubles; lam stays in [1e-12, 1e10].

Every product of matrices is a torch matrix product: computed in float32
with TF32 on, this reference is the benchmark's control. It imports
nothing of the program and nothing of JAX.
"""

from typing import NamedTuple

import numpy as np
import torch

# landmarks x cameras x 18 entries of one block of B at a time
CHUNK_ELEMS = 2 ** 24


class Problem(NamedTuple):
    cam: torch.Tensor     # (N,) int64, observations with weight > 0,
    lm: torch.Tensor      # (N,) int64  sorted by their landmark's rank
    rank: torch.Tensor    # (N,) int64 the rank of lm in the chunk order
    uv: torch.Tensor      # (N, 2)
    w: torch.Tensor       # (N,)
    fixed: torch.Tensor   # (C,) bool
    n_cams: int
    n_points: int
    chunks: tuple         # (l0, l1, o0, o1, c0, c1) in the rank order


def first_camera(cam, lm, n_points):
    """(L,) the lowest camera that observes each landmark, 0 where none."""
    first = np.full(n_points, np.iinfo(np.int64).max)
    np.minimum.at(first, lm, cam)
    return np.where(first == np.iinfo(np.int64).max, 0, first)


def problem(cam, lm, uv, w, n_cams, n_points, fixed, dtype, device):
    """The reference's own layout of numpy observations: those of weight
    > 0, landmarks ordered by their first camera, and chunks of landmarks
    whose dense block of B (3 rows a landmark, 6 columns a camera of the
    chunk's camera range) holds at most CHUNK_ELEMS entries."""
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
            if (l1 + 1 - l0) * 18 * (hi - c_lo + 1) > CHUNK_ELEMS:
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


def _hat(p):
    z = torch.zeros_like(p[..., 0])
    return torch.stack([torch.stack([z, -p[..., 2], p[..., 1]], -1),
                        torch.stack([p[..., 2], z, -p[..., 0]], -1),
                        torch.stack([-p[..., 1], p[..., 0], z], -1)], -2)


def so3_exp(w):
    th2 = (w * w).sum(-1)[..., None, None]
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th ** 2)
    K = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def retract(R, t, X, dp, dl):
    return R @ so3_exp(dp[:, :3]), t + dp[:, 3:], X + dl


def cost(R, t, X, P: Problem):
    """0.5 sum w |d|^2 over the problem's observations."""
    return _residuals(R, t, X, P)[0]


def _residuals(R, t, X, P: Problem):
    Rc = R[P.cam]
    p = X[P.lm]
    pc = (Rc @ p[:, :, None])[..., 0] + t[P.cam]
    iz = 1.0 / pc[:, 2]
    u, v = pc[:, 0] * iz, pc[:, 1] * iz
    d = torch.stack([u - P.uv[:, 0], v - P.uv[:, 1]], -1)
    return 0.5 * (P.w * (d * d).sum(-1)).sum(), d, Rc, p, u, v, iz


def normal_equations(R, t, X, P: Problem):
    """((Hpp (C, 6, 6), gp (C, 6), Hll (L, 3, 3), gl (L, 3), Wo (N, 6, 3)),
    cost), with the observations' rows scaled by sqrt(w)."""
    c, d, Rc, p, u, v, iz = _residuals(R, t, X, P)
    sw = torch.sqrt(P.w)
    z0 = torch.zeros_like(iz)
    Jproj = torch.stack([torch.stack([iz, z0, -u * iz], -1),
                         torch.stack([z0, iz, -v * iz], -1)], -2)   # (N, 2, 3)
    Jl = Jproj @ Rc
    Jp = torch.cat([-(Jl @ _hat(p)), Jproj], -1) * sw[:, None, None]
    Jl = Jl * sw[:, None, None]
    r = d * sw[:, None]
    C, L = P.n_cams, P.n_points
    dtype, device = R.dtype, R.device
    Hpp = torch.zeros((C, 6, 6), dtype=dtype, device=device).index_add_(
        0, P.cam, Jp.mT @ Jp)
    gp = torch.zeros((C, 6), dtype=dtype, device=device).index_add_(
        0, P.cam, (Jp.mT @ r[:, :, None])[..., 0])
    Hll = torch.zeros((L, 3, 3), dtype=dtype, device=device).index_add_(
        0, P.lm, Jl.mT @ Jl)
    gl = torch.zeros((L, 3), dtype=dtype, device=device).index_add_(
        0, P.lm, (Jl.mT @ r[:, :, None])[..., 0])
    Wo = Jp.mT @ Jl
    return (Hpp, gp, Hll, gl, Wo), c


def damped_step(H, lam, P: Problem):
    """The damped, gauge-fixed Gauss-Newton step: (dp (C, 6), dl (L, 3),
    Marquardt diagonals dpp (C, 6), dll (L, 3))."""
    Hpp, gp, Hll, gl, Wo = H
    C, L = P.n_cams, P.n_points
    dtype, device = gp.dtype, gp.device
    dpp = torch.clamp_min(torch.diagonal(Hpp, dim1=-2, dim2=-1), 1e-12)
    dll = torch.clamp_min(torch.diagonal(Hll, dim1=-2, dim2=-1), 1e-12)
    empty = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1) <= 0
    eye3 = torch.eye(3, dtype=dtype, device=device)
    Hll_d = torch.where(empty[:, None, None], eye3,
                        Hll + torch.diag_embed(lam * dll))
    Lc = torch.linalg.cholesky(Hll_d)
    Hinv = torch.cholesky_inverse(Lc)
    Xo = torch.linalg.solve_triangular(Lc[P.lm], Wo.mT,
                                       upper=False)          # (N, 3, 6)

    S = torch.zeros((6 * C, 6 * C), dtype=dtype, device=device)
    for l0, l1, o0, o1, c0, c1 in P.chunks:
        nl, nc = l1 - l0, c1 - c0
        Bc = torch.zeros((nl, nc, 3, 6), dtype=dtype, device=device)
        Bc.index_put_((P.rank[o0:o1] - l0, P.cam[o0:o1] - c0), Xo[o0:o1],
                      accumulate=True)
        B2 = Bc.permute(0, 2, 1, 3).reshape(3 * nl, 6 * nc)
        S[6 * c0:6 * c1, 6 * c0:6 * c1] -= B2.T @ B2
    ci = torch.arange(C, device=device)
    S4 = S.view(C, 6, C, 6)
    S4[ci, :, ci, :] += Hpp + torch.diag_embed(lam * dpp)

    u = (Hinv @ gl[:, :, None])[..., 0]
    y = torch.zeros((C, 6), dtype=dtype, device=device).index_add_(
        0, P.cam, (Wo @ u[P.lm][:, :, None])[..., 0])
    b = -(gp - y)
    free = (~P.fixed).to(dtype)
    S4 *= free[:, None, None, None] * free[None, None, :, None]
    S4[ci, :, ci, :] += (1.0 - free)[:, None, None] * torch.eye(
        6, dtype=dtype, device=device)
    b = b * free[:, None]
    Ls, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        nan = torch.full((C, 6), torch.nan, dtype=dtype, device=device)
        return nan, torch.full((L, 3), torch.nan, dtype=dtype,
                               device=device), dpp, dll
    dp = torch.cholesky_solve(b.reshape(-1, 1), Ls).reshape(C, 6)
    tl = torch.zeros((L, 3), dtype=dtype, device=device).index_add_(
        0, P.lm, (Wo.mT @ dp[P.cam][:, :, None])[..., 0])
    dl = (Hinv @ (-gl - tl)[:, :, None])[..., 0]
    return dp, dl, dpp, dll


class State(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    costs: list       # floats: the start's cost, then after each step
    it: int


def solve(R, t, X, P: Problem, iters, lambda_init=1e-4, xtol=1e-12):
    """`iters` LM steps (fewer where an accepted step is shorter than
    xtol) from (R, t, X)."""
    H, c = normal_equations(R, t, X, P)
    c = float(c)
    lam, nu = lambda_init, 2.0
    costs = [c]
    it = 0
    while it < iters:
        dp, dl, dpp, dll = damped_step(H, lam, P)
        bad = not bool(torch.isfinite(dp).all() & torch.isfinite(dl).all())
        if bad:
            dp, dl = torch.zeros_like(dp), torch.zeros_like(dl)
        R1, t1, X1 = retract(R, t, X, dp, dl)
        H1, c1 = normal_equations(R1, t1, X1, P)
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
            R, t, X, H, c = R1, t1, X1, H1, c1
        costs.append(c)
        it += 1
        if accept and step_sq < xtol * xtol:
            break
    return State(R, t, X, costs, it)
