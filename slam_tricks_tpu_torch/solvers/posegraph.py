"""SE(3) pose-graph optimization: LM over relative-pose factors.

Port of ``slam_tricks_tpu/solvers/posegraph.py``, three solvers with the
JAX package's damping, gauge and trust-region semantics:

- ``solve_pose_graph``: the dense (6N, 6N) normal equations, solved by
  ``ops.spd_solve`` (the CUDA kernel on the card), for graphs up to a few
  hundred poses.
- ``solve_pose_graph_chain``: odometry chain plus loop closures. The
  Hessian is block-tridiagonal over the chain plus one rank-6 term a loop
  edge, H + lam D = T + U Uᵀ, solved through the stored block-tridiagonal
  factor of T (``banded_flat.block_tridiag_factor``) and the (q, q) Gram
  capacitance I + UtᵀUt (``spd_solve``).
- ``solve_pose_graph_relative``: the f32-native large-N path. The state is
  the odometry increments m_k = T_{k-1}^-1 T_k, so the chain Hessian is
  block-diagonal; loop closures add U Uᵀ through the adjoints of the
  composed poses, solved by batched 6x6 Cholesky and the QR-orthogonalized
  capacitance (``spd_solve``).

Edge Jacobians are analytic: the inverse right Jacobian of the residual,
phi1(-ad(r))^-1, and the adjoint that carries a perturbation of P_i to the
residual's side; they equal the JAX package's ``jax.jacfwd`` derivatives
to rounding. Every sum over edges runs in an order fixed
before the LM loop (``common.sum_table`` / ``table_sum``), so two runs on
the card give the same bits. The LM loop runs on the host over device
tensors with one sync (the stop flag) a step, as ``schur.lm_loop``.
"""

from typing import NamedTuple

import numpy as np
import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import se3, sim3, so3
from slam_tricks_tpu_torch.ops.spd_solve import spd_solve
from slam_tricks_tpu_torch.residuals.posegraph import relative_se3_residual
from slam_tricks_tpu_torch.solvers.banded_flat import (_chol,
                                                       block_tridiag_factor,
                                                       tridiag_backward,
                                                       tridiag_forward)
from slam_tricks_tpu_torch.solvers.common import (associative_scan,
                                                  first_camera_fixed,
                                                  set_full_precision,
                                                  sum_table, table_sum)
from slam_tricks_tpu_torch.solvers.schur import lm_accept

LAM_MIN = 1e-14     # the pose-graph solvers' damping floor
UPCAST_N = 384      # the chain solver runs f32 input above this N in f64


class PoseGraphState(NamedTuple):
    poses: se3.SE3
    cost: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    it: int             # LM iterations run
    done: bool          # stopped on the step-size test or a bad step


def _take(poses, idx):
    return type(poses)(*(a[idx] for a in poses))


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def _ee(a, b):
    """aᵀ b over edges: (E, r, i), (E, r, j) -> (E, i, j)."""
    return a.mT @ b


def _ev(a, r):
    """aᵀ r over edges: (E, r, i), (E, r) -> (E, i)."""
    return _matvec(a.mT, r)


def ad_se3(xi):
    """(..., 6, 6) adjoint of the algebra at xi = [rho, omega]:
    [[hat(omega), hat(rho)], [0, hat(omega)]], so that Adj(exp(xi)) =
    exp(ad(xi))."""
    W = so3.hat(xi[..., 3:])
    return torch.cat([torch.cat([W, so3.hat(xi[..., :3])], dim=-1),
                      torch.cat([torch.zeros_like(W), W], dim=-1)], dim=-2)


def right_jacobian_inv(ad_r):
    """Jr^-1(r) = phi1(-ad(r))^-1, d log(exp(r) exp(delta)) / d delta at
    delta = 0, from ad(r) (..., n, n). ``inv_ex``: no error check, so no
    sync with the card (Jr is regular for theta < 2 pi)."""
    return torch.linalg.inv_ex(sim3._phi1(-ad_r)).inverse


def edge_linearize(group, residual, ad, poses, i_idx, j_idx, Z, sqrt_info):
    """Whitened residuals r = L log(Z^-1 P_i^-1 P_j) of a group module's
    relative factors and their Jacobians with respect to right
    perturbations of P_i and P_j, (r (E, d), Ji (E, d, d), Jj (E, d, d)):
    Jj = L Jr^-1(r) and Ji = -Jj Adj(P_j^-1 P_i), the derivatives that the
    JAX package takes with ``jax.jacfwd`` (held to them in the tests)."""
    Pi, Pj = _take(poses, i_idx), _take(poses, j_idx)
    r = residual(Pi, Pj, Z)
    Jj = sqrt_info @ right_jacobian_inv(ad(r))
    Ji = -(Jj @ group.adj(group.mul(group.inv(Pj), Pi)))
    return _matvec(sqrt_info, r), Ji, Jj


def edge_cost(residual, poses, i_idx, j_idx, Z, sqrt_info):
    r = _matvec(sqrt_info, residual(_take(poses, i_idx), _take(poses, j_idx),
                                    Z))
    return 0.5 * torch.sum(r * r)


def _edge_linearize(poses, i_idx, j_idx, Z, sqrt_info):
    """Per-edge residual and Jacobians of the SE(3) factor: (r (E, 6),
    Ji (E, 6, 6), Jj (E, 6, 6))."""
    return edge_linearize(se3, relative_se3_residual, ad_se3, poses, i_idx,
                          j_idx, Z, sqrt_info)


def _pg_cost(poses, i_idx, j_idx, Z, sqrt_info):
    return edge_cost(relative_se3_residual, poses, i_idx, j_idx, Z, sqrt_info)


def lm_solve(poses0, cost_fn, propose, retract, *, max_iters, lambda_init,
             xtol, costs=None):
    """The LM loop of the pose-graph solvers. propose(poses, lam) ->
    (delta (N, d), g (N, d), dscale (N, d)): the step, the gradient and the
    diagonal of the predicted reduction 0.5 sum(delta (lam dscale delta -
    g)); a non-finite step becomes a zero step and stops the loop. If
    `costs` is a list, the cost at the start and after each step is
    appended (device scalars). Returns a PoseGraphState."""
    dtype, device = poses0.t.dtype, poses0.t.device
    poses = poses0
    cost = cost_fn(poses)
    lam = torch.tensor(lambda_init, dtype=dtype, device=device)
    nu = torch.tensor(2.0, dtype=dtype, device=device)
    it, done = 0, False
    if costs is not None:
        costs.append(cost)
    while not done and it < max_iters:
        delta, g, dscale = propose(poses, lam)
        bad = ~torch.isfinite(delta).all()
        delta = torch.where(bad, torch.zeros_like(delta), delta)
        poses_try = retract(poses, delta)
        cost_try = cost_fn(poses_try)
        pred = 0.5 * torch.sum(delta * (lam * dscale * delta - g))
        accept, lam, nu = lm_accept(cost, cost_try, lam, nu, pred, bad,
                                    LAM_MIN)
        stop = (accept & (torch.sum(delta * delta) < xtol * xtol)) | bad
        poses = type(poses)(*(torch.where(accept, a, b)
                              for a, b in zip(poses_try, poses)))
        cost = torch.where(accept, cost_try, cost)
        it += 1
        if costs is not None:
            costs.append(cost)
        done = bool(stop)                               # one sync a step
    return PoseGraphState(poses=poses, cost=cost, lam=lam, nu=nu, it=it,
                          done=done)


# ---- the dense solver ----

class DenseTables(NamedTuple):
    """The fixed summation orders of the dense normal equations of one
    edge list, built once a problem."""
    blocks: torch.Tensor        # (U,) the nonzero blocks i N + j
    block_table: torch.Tensor   # (U, T) the edge blocks of each
    node_table: torch.Tensor    # (N, T) the edge gradients of each pose


def dense_tables(i_idx, j_idx, n):
    """``DenseTables`` of edges (i_idx, j_idx) over n poses; the edge
    blocks are ordered (ii, jj, ij, ji), E each."""
    i, j = i_idx.long(), j_idx.long()
    keys = torch.cat([i * n + i, j * n + j, i * n + j, j * n + i])
    blocks, slot = torch.unique(keys, return_inverse=True)
    return DenseTables(blocks, sum_table(slot, blocks.shape[0]),
                       sum_table(torch.cat([i, j]), n))


def dense_step(r, Ji, Jj, lam, fixed_mask, tables: DenseTables):
    """One damped Gauss-Newton step of the dense normal equations:
    (delta (N, d), g (N, d), the damped diagonal (N, d)). H is formed by
    fixed-order table sums, Marquardt-damped on its diagonal blocks, the
    fixed poses' rows and columns replaced by the identity, and solved by
    ``spd_solve``."""
    E, d = r.shape
    n = fixed_mask.shape[0]
    dtype = r.dtype
    Hb = table_sum(torch.cat([_ee(Ji, Ji), _ee(Jj, Jj), _ee(Ji, Jj),
                              _ee(Jj, Ji)]).reshape(4 * E, d * d).T,
                   tables.block_table)
    H = r.new_zeros(n * n, d * d)
    H[tables.blocks] = Hb
    H = H.reshape(n, n, d, d)
    g = table_sum(torch.cat([_ev(Ji, r), _ev(Jj, r)]).T, tables.node_table)

    diag = torch.arange(n, device=r.device)
    Hd = H[diag, diag]
    dd = torch.clamp_min(torch.diagonal(Hd, dim1=-2, dim2=-1), 1e-12)
    H[diag, diag] = Hd + lam * torch.diag_embed(dd)
    free = (~fixed_mask).to(dtype)
    H = H * free[:, None, None, None] * free[None, :, None, None]
    H[diag, diag] = H[diag, diag] + (torch.eye(d, dtype=dtype, device=r.device)
                                     * fixed_mask.to(dtype)[:, None, None])
    g = g * free[:, None]
    A = H.permute(0, 2, 1, 3).reshape(n * d, n * d).contiguous()
    delta = spd_solve(A, -g.reshape(n * d))
    return (delta.reshape(n, d), g,
            torch.clamp_min(torch.diagonal(A), 1e-12).reshape(n, d))


def solve_pose_graph(poses0, i_idx, j_idx, Z, sqrt_info=None, *,
                     fixed_mask=None, max_iters=50, lambda_init=1e-6,
                     xtol=1e-12, costs=None):
    """LM pose-graph solve. poses0: stacked SE3 (N,); edges (E,) index
    tensors with measurements Z (stacked SE3 (E,)) and optional (E, 6, 6)
    square-root information; pose 0 fixed by default. The predicted
    reduction uses the damped diagonal, lam d (1 + lam), as the JAX
    package's does. If `costs` is a list, the costs are appended to it.
    Returns PoseGraphState."""
    set_full_precision()
    N = poses0.t.shape[0]
    E = i_idx.shape[0]
    dtype, device = poses0.t.dtype, poses0.t.device
    i_idx, j_idx = i_idx.long(), j_idx.long()
    if sqrt_info is None:
        sqrt_info = torch.eye(6, dtype=dtype, device=device).expand(E, 6, 6)
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(N, device)
    tables = dense_tables(i_idx, j_idx, N)

    def propose(poses, lam):
        r, Ji, Jj = _edge_linearize(poses, i_idx, j_idx, Z, sqrt_info)
        return dense_step(r, Ji, Jj, lam, fixed_mask, tables)

    return lm_solve(poses0,
                    lambda p: _pg_cost(p, i_idx, j_idx, Z, sqrt_info),
                    propose, se3.retract, max_iters=max_iters,
                    lambda_init=lambda_init, xtol=xtol, costs=costs)


# ---- the chain solver ----

def _compose_chain(T0, m):
    """Absolute poses from relative increments, T_k = T0 m_1 ... m_k, by a
    log-depth scan (``common.associative_scan``, the JAX package's order).
    Returns stacked SE3 of length P + 1, T0 at index 0."""
    Rc, tc = associative_scan(
        lambda a, b: (a[0] @ b[0], _matvec(a[0], b[1]) + a[1]), (m.R, m.t))
    Rabs = T0.R @ Rc
    tabs = _matvec(T0.R, tc) + T0.t
    return se3.SE3(torch.cat([T0.R[None], Rabs]),
                   torch.cat([T0.t[None], tabs]))


class ChainGraphWork(NamedTuple):
    """Host-split edge structure of the chain and loop-closure solvers."""
    Z_chain: se3.SE3          # (N-1,) measurement i -> i+1 (identity if absent)
    info_chain: torch.Tensor  # (N-1, 6, 6) sqrt-information (0 if absent)
    loop_i: torch.Tensor      # (E,) int64
    loop_j: torch.Tensor      # (E,) int64
    Z_loop: se3.SE3           # (E,)
    info_loop: torch.Tensor   # (E, 6, 6) sqrt-information (0 for padding)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def build_chain_work(i_idx, j_idx, Z, sqrt_info, n_poses,
                     dtype=torch.float32, device=None):
    """Split general edges into the odometry chain (j == i + 1, slotted by
    i) and loop-closure edges (everything else, padded to a multiple of 8
    with zero information). numpy on the host; the tensors go to `device`,
    the card unless the caller names another."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    i_np, j_np = _np(i_idx), _np(j_idx)
    N = int(n_poses)
    is_chain = j_np == i_np + 1
    Rz, tz, info = _np(Z.R), _np(Z.t), _np(sqrt_info)

    Rc = np.tile(np.eye(3, dtype=np_dtype), (N - 1, 1, 1))
    tc = np.zeros((N - 1, 3), np_dtype)
    Ic = np.zeros((N - 1, 6, 6), np_dtype)
    ci = i_np[is_chain]
    if np.unique(ci).size != ci.size:
        raise ValueError("duplicate chain edge")
    Rc[ci] = Rz[is_chain]
    tc[ci] = tz[is_chain]
    Ic[ci] = info[is_chain]

    li, lj = i_np[~is_chain], j_np[~is_chain]
    E = li.size
    Ep = max(E + (-E) % 8, 8)
    loop_i = np.zeros(Ep, np.int64)
    loop_j = np.zeros(Ep, np.int64)
    Rl = np.tile(np.eye(3, dtype=np_dtype), (Ep, 1, 1))
    tl = np.zeros((Ep, 3), np_dtype)
    Il = np.zeros((Ep, 6, 6), np_dtype)
    loop_i[:E] = li
    loop_j[:E] = lj
    Rl[:E] = Rz[~is_chain]
    tl[:E] = tz[~is_chain]
    Il[:E] = info[~is_chain]
    device = resolve(device)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return ChainGraphWork(Z_chain=se3.SE3(t(Rc), t(tc)), info_chain=t(Ic),
                          loop_i=t(loop_i), loop_j=t(loop_j),
                          Z_loop=se3.SE3(t(Rl), t(tl)), info_loop=t(Il))


def _cast(tree, dtype):
    """A copy of a tuple tree with its floating tensors in `dtype`."""
    if isinstance(tree, tuple):
        return type(tree)(*(_cast(x, dtype) for x in tree))
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _pg_cost_chain(poses, work: ChainGraphWork):
    N = poses.t.shape[0]
    ic = torch.arange(N - 1, device=poses.t.device)
    c1 = _pg_cost(poses, ic, ic + 1, work.Z_chain, work.info_chain)
    c2 = _pg_cost(poses, work.loop_i, work.loop_j, work.Z_loop,
                  work.info_loop)
    return c1 + c2


def _chain_step(poses, lam, work: ChainGraphWork, free, loop_table):
    """One damped step of the chain solver: (delta, g, dscale)."""
    N = poses.t.shape[0]
    dtype, device = poses.t.dtype, poses.t.device
    eye6 = torch.eye(6, dtype=dtype, device=device)
    ic = torch.arange(N - 1, device=device)

    # the chain: shifted adds, no sums across edges
    rc, Jic, Jjc = _edge_linearize(poses, ic, ic + 1, work.Z_chain,
                                   work.info_chain)
    z1 = poses.t.new_zeros(1, 6, 6)
    D = (torch.cat([_ee(Jic, Jic), z1]) + torch.cat([z1, _ee(Jjc, Jjc)]))
    Esub = _ee(Jjc, Jic)                                    # (N-1, 6, 6)
    zv = poses.t.new_zeros(1, 6)
    g = torch.cat([_ev(Jic, rc), zv]) + torch.cat([zv, _ev(Jjc, rc)])

    # the loop closures: their gradients and diagonals summed a pose
    rl, Jil, Jjl = _edge_linearize(poses, work.loop_i, work.loop_j,
                                   work.Z_loop, work.info_loop)
    g = g + table_sum(torch.cat([_ev(Jil, rl), _ev(Jjl, rl)]).T, loop_table)
    loop_diag = torch.cat([torch.diagonal(_ee(Jil, Jil), dim1=-2, dim2=-1),
                           torch.diagonal(_ee(Jjl, Jjl), dim1=-2, dim2=-1)])

    # Marquardt damping from the total diagonal; poses with no
    # information get the identity
    diag = (torch.diagonal(D, dim1=-2, dim2=-1)
            + table_sum(loop_diag.T, loop_table))
    dscale = torch.clamp_min(diag, 1e-12)
    untouched = torch.sum(diag, dim=1) <= 0.0
    T = D + lam * torch.diag_embed(dscale)
    T = torch.where(untouched[:, None, None], eye6, T)

    # gauge: fixed poses masked, unit diagonal
    T = T * (free * free)[:, None, None] + eye6 * (1.0 - free)[:, None, None]
    Esub_m = Esub * (free[1:] * free[:-1])[:, None, None]
    g = g * free[:, None]

    # the loop-edge factor U (N, 6, q), rows gauge-masked
    E = work.loop_i.shape[0]
    q = 6 * E
    er = torch.arange(E, device=device)
    li, lj = work.loop_i, work.loop_j
    U = poses.t.new_zeros(N, 6, E, 6)
    U[li, :, er, :] = Jil.mT * free[li][:, None, None]
    U[lj, :, er, :] = U[lj, :, er, :] + Jjl.mT * free[lj][:, None, None]
    U = U.reshape(N, 6, q)

    # one multi-RHS substitution through the stored factor T = Lt Ltᵀ, then
    # the Gram capacitance: (T + U Uᵀ)^-1 b = Lt^-T [c - Ut (I + UtᵀUt)^-1
    # Utᵀ c], Ut = Lt^-1 U, c = Lt^-1 b
    fac = block_tridiag_factor(T, Esub_m)
    Y = tridiag_forward(fac, torch.cat([-g[..., None], U], dim=-1))
    c, Ut = Y[..., 0], Y[..., 1:]
    Utf = Ut.reshape(N * 6, q)
    cap = torch.eye(q, dtype=dtype, device=device) + Utf.T @ Utf
    z = spd_solve(cap, Utf.T @ c.reshape(N * 6))
    y = c - _matvec(Ut, z)
    return tridiag_backward(fac, y), g, dscale


def solve_pose_graph_chain(poses0, work: ChainGraphWork, *, fixed_mask=None,
                           max_iters=50, lambda_init=1e-6, xtol=1e-12,
                           costs=None):
    """Exact LM pose-graph solve at chain plus loop-closure scale: the
    block-tridiagonal factor over the odometry chain plus a rank-6-a-loop-
    edge Woodbury correction. The same damping, gauge and trust-region
    semantics as solve_pose_graph.

    An odometry chain's Hessian conditioning grows ~N^3 and passes 1/eps32
    near N ~ 500-600, so f32 input with N > 384 is solved in f64 and the
    result cast back to f32. The JAX package does so when x64 is enabled
    and raises ValueError otherwise; torch always has f64, so that branch
    has no counterpart here."""
    N = poses0.t.shape[0]
    if poses0.t.dtype == torch.float32 and N > UPCAST_N:
        out = solve_pose_graph_chain(
            _cast(poses0, torch.float64), _cast(work, torch.float64),
            fixed_mask=fixed_mask, max_iters=max_iters,
            lambda_init=lambda_init, xtol=xtol, costs=costs)
        if costs is not None:
            costs[:] = [c.float() for c in costs]
        return _cast(out, torch.float32)
    set_full_precision()
    dtype, device = poses0.t.dtype, poses0.t.device
    if fixed_mask is None:
        fixed_mask = first_camera_fixed(N, device)
    free = (~fixed_mask).to(dtype)
    loop_table = sum_table(torch.cat([work.loop_i, work.loop_j]).long(), N)
    return lm_solve(
        poses0, lambda p: _pg_cost_chain(p, work),
        lambda p, lam: _chain_step(p, lam, work, free, loop_table),
        se3.retract, max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
        costs=costs)


# ---- the relative-state solver ----

def _relative_step(m, lam, T0, work: ChainGraphWork, chain_r_J, karr):
    """One damped step of the relative-state solver: (delta, g, dscale)."""
    P = m.t.shape[0]
    E = work.loop_i.shape[0]
    q = 6 * E
    dtype, device = m.t.dtype, m.t.device
    T = _compose_chain(T0, m)

    # the chain: block-diagonal normal equations
    rc, Jc = chain_r_J(m)
    D = _ee(Jc, Jc)                                         # (P, 6, 6)
    g = _ev(Jc, rc)                                         # (P, 6)

    # loop closures: linearized in absolute coordinates, then carried onto
    # the increments through Adj(T_j^-1 T_g)
    rl, _, Jjl = _edge_linearize(T, work.loop_i, work.loop_j, work.Z_loop,
                                 work.info_loop)
    B = Jjl @ se3.adj(se3.inv(_take(T, work.loop_j)))       # (E, 6, 6)
    AdT = se3.adj(_take(T, slice(1, None)))                 # (P, 6, 6)
    mask = ((karr[:, None] >= work.loop_i[None, :])
            & (karr[:, None] < work.loop_j[None, :])).to(dtype)
    # U[k, a, (e, c)] = sum_b Adj_{k+1}[b, a] B_e[c, b]
    U = ((AdT.mT.reshape(P * 6, 6) @ B.reshape(q, 6).T).reshape(P, 6, E, 6)
         * mask[:, None, :, None]).reshape(P, 6, q)
    g = g + _matvec(U, rl.reshape(q))

    # Marquardt damping on the total diagonal; blocks kept SPD
    dscale = torch.clamp_min(torch.diagonal(D, dim1=-2, dim2=-1)
                             + torch.sum(U * U, dim=2), 1e-12)   # (P, 6)
    Dd = D + lam * torch.diag_embed(dscale)
    Dd = Dd + torch.eye(6, dtype=dtype, device=device) * 1e-10

    # Woodbury through the QR-orthogonalized loop subspace: W = chol(Dd),
    # Ut = W^-1 U = Q R, c = W^-1 b; y = c - Q (Qᵀ c - w) with
    # (I + R Rᵀ) w = Qᵀ c, whose error is relative to the small w, not to
    # the large c of a drifted start
    W = _chol(Dd)
    sol = torch.linalg.solve_triangular(
        W, torch.cat([-g[..., None], U], dim=-1), upper=False)
    c, Ut = sol[..., 0], sol[..., 1:]
    Qm, Rm = torch.linalg.qr(Ut.reshape(P * 6, q), mode="reduced")
    cf = c.reshape(P * 6)
    cap = torch.eye(q, dtype=dtype, device=device) + Rm @ Rm.T
    qc = Qm.T @ cf
    w = spd_solve(cap, qc)
    y = (cf - Qm @ (qc - w)).reshape(P, 6)
    delta = torch.linalg.solve_triangular(W.mT, y[..., None], upper=True)
    return delta[..., 0], g, dscale


def solve_pose_graph_relative(poses0, work: ChainGraphWork, *, max_iters=50,
                              lambda_init=1e-6, xtol=1e-12, costs=None):
    """Large-scale pose-graph LM in f32, in the relative-state formulation
    (the state is the odometry increments m_k = T_{k-1}^-1 T_k): the chain
    Hessian is block-diagonal (condition O(1)), and each loop closure (i, j)
    adds U_e U_eᵀ with rows Jabs_e Adj(T_j^-1 T_g) over i < g <= j. All of
    it is batched 6x6 algebra, two (6P, q) products, a QR and one log-depth
    compose scan. The gauge is T_0 fixed. The LM trajectory differs from
    the absolute-state solvers (damping acts on the increments), so they
    agree at the optimum. Returns PoseGraphState with absolute poses."""
    set_full_precision()
    N = poses0.t.shape[0]
    P = N - 1
    device = poses0.t.device
    T0 = se3.SE3(poses0.R[0], poses0.t[0])
    m0 = se3.mul(se3.inv(_take(poses0, slice(None, -1))),
                 _take(poses0, slice(1, None)))
    Zc_inv = se3.inv(work.Z_chain)
    karr = torch.arange(P, device=device)

    def chain_r_J(m):
        """Whitened chain residuals L log(Z_k^-1 m_k) and their 6x6
        Jacobians L Jr^-1 with respect to a right perturbation of each
        m_k, the one block a factor touches."""
        r = se3.log(se3.mul(Zc_inv, m))
        return (_matvec(work.info_chain, r),
                work.info_chain @ right_jacobian_inv(ad_se3(r)))

    def total_cost(m):
        rc = _matvec(work.info_chain, se3.log(se3.mul(Zc_inv, m)))
        c2 = _pg_cost(_compose_chain(T0, m), work.loop_i, work.loop_j,
                      work.Z_loop, work.info_loop)
        return 0.5 * torch.sum(rc * rc) + c2

    out = lm_solve(
        m0, total_cost,
        lambda m, lam: _relative_step(m, lam, T0, work, chain_r_J, karr),
        se3.retract, max_iters=max_iters, lambda_init=lambda_init, xtol=xtol,
        costs=costs)
    return out._replace(poses=_compose_chain(T0, out.poses))
