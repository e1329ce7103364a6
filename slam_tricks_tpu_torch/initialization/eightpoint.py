"""Normalized 8-point fundamental / essential matrix estimation and pose
recovery (port of ``slam_tricks_tpu/initialization/eightpoint.py``;
st2-epipolar epipolar.hpp:64-228, recovery.hpp:25-129,
st22-two-view two_view_geometry.cpp:18-126).

Every function takes leading batch dimensions where the JAX package maps
with ``vmap``: correspondences (..., N, 2), weights (..., N), matrices
(..., 3, 3). Degenerate configurations give an identity-like F with ok
False and points behind a camera, never an exception: nothing reads a
tensor on the host.

Eigen- and singular vectors are defined up to sign, and the two libraries
may pick either: F and E agree with the JAX package's up to sign, and
``decompose_essential``'s determinant fix and ``recover_pose``'s
cheirality vote make the recovered (R, t) unique.
"""

import torch


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def nullvec_normal(A):
    """The smallest right-singular vector of A (..., N, m) from ``eigh`` of
    the m x m normal matrix AᵀA (ascending eigenvalues). Returns
    (v (..., m), singular values (..., m) descending)."""
    evals, evecs = torch.linalg.eigh(A.mT @ A)
    sv = torch.sqrt(torch.clamp_min(evals.flip(-1), 0.0))
    return evecs[..., :, 0], sv


def hartley_normalize(pts):
    """The similarity moving points (..., N, 2) to centroid 0 and mean
    distance sqrt(2) (epipolar.hpp:64-116): (pts_norm (..., N, 2),
    T (..., 3, 3))."""
    mean = pts.mean(dim=-2)
    centered = pts - mean[..., None, :]
    scale = (2.0 ** 0.5) / torch.clamp_min(
        torch.linalg.vector_norm(centered, dim=-1).mean(dim=-1), 1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    # built out of place, so that it maps under torch.func.vmap (RANSAC's
    # minimal fits)
    T = torch.stack([torch.stack([scale, zero, -scale * mean[..., 0]], -1),
                     torch.stack([zero, scale, -scale * mean[..., 1]], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    return centered * scale[..., None, None], T


def fundamental_8pt(p1, p2, weights=None, return_ok=False):
    """F (..., 3, 3), ||F|| = 1, from >= 8 correspondences p1, p2
    (..., N, 2) (pixels or normalized coordinates), Hartley normalized and
    projected to rank 2. A degenerate configuration (the 8th singular
    value not well above the 9th: coplanar points, pure rotation,
    duplicates; two_view_geometry.cpp:77-80) gives the identity and ok
    False."""
    n1, T1 = hartley_normalize(p1)
    n2, T2 = hartley_normalize(p2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    if weights is not None:
        A = A * weights[..., None]
    v, sv = nullvec_normal(A)
    F = v.reshape(v.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    F = (U * torch.stack([S[..., 0], S[..., 1], torch.zeros_like(S[..., 2])],
                         dim=-1)[..., None, :]) @ Vt
    F = T2.mT @ F @ T1
    F = F / torch.clamp_min(torch.linalg.matrix_norm(F), 1e-30)[..., None,
                                                                 None]
    eps = torch.finfo(A.dtype).eps
    ok = torch.isfinite(F).all(dim=(-2, -1)) & (sv[..., 7] > 1e3 * eps
                                                 * sv[..., 0])
    F = torch.where(ok[..., None, None], F,
                    torch.eye(3, dtype=F.dtype, device=F.device))
    return (F, ok) if return_ok else F


def essential_from_fundamental(F, K1, K2=None):
    """E = K2ᵀ F K1 (epipolar.hpp:223-228), ||E|| = 1."""
    K2 = K1 if K2 is None else K2
    E = K2.mT @ F @ K1
    return E / torch.linalg.matrix_norm(E)[..., None, None]


def essential_8pt(p1_norm, p2_norm, weights=None, return_ok=False):
    """E from normalized-plane correspondences (..., N, 2), with the
    (1, 1, 0) singular-value projection; return_ok adds the degeneracy
    flag."""
    F, ok = fundamental_8pt(p1_norm, p2_norm, weights, return_ok=True)
    U, S, Vt = torch.linalg.svd(F)
    one = torch.ones_like(S[..., 0])
    E = (U * torch.stack([one, one, torch.zeros_like(one)], dim=-1)
         [..., None, :]) @ Vt
    E = E / torch.clamp_min(torch.linalg.matrix_norm(E), 1e-30)[..., None,
                                                                 None]
    return (E, ok) if return_ok else E


def decompose_essential(E):
    """E (..., 3, 3) -> the 4 candidate (R (..., 4, 3, 3), t (..., 4, 3)):
    (R1, t), (R1, -t), (R2, t), (R2, -t), U and Vᵀ made proper rotations
    (recovery.hpp:25-129)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def triangulate_midpoint(R, t, p1, p2):
    """Two-view midpoint triangulation for cam1 = [I | 0], cam2 = [R | t] on
    normalized coordinates p1, p2 (..., 2), R (..., 3, 3) and t (..., 3)
    broadcasting against them: the two ray parameters solve the 2x2 normal
    equations of [R x1, -x2] d = -t, the point is the midpoint of the two
    ray feet (st2 triangulation.hpp:21-76). Near-parallel rays give finite X
    and depths -1, so they fail the cheirality test. Returns (X (..., 3),
    depth1, depth2)."""
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    x2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    r1 = _matvec(R, x1)               # ray 1's direction in cam-2 frame
    g00 = (r1 * r1).sum(dim=-1)
    g01 = -(r1 * x2).sum(dim=-1)
    g11 = (x2 * x2).sum(dim=-1)
    b0 = -(r1 * t).sum(dim=-1)
    b1 = (x2 * t).sum(dim=-1)
    det = g00 * g11 - g01 * g01       # >= 0; 0 for parallel rays
    scale = torch.clamp_min(g00 * g11, 1e-30)
    ok = det > 8.0 * torch.finfo(p1.dtype).eps * scale
    det_safe = torch.where(ok, det, torch.ones_like(det))
    minus = -torch.ones_like(det)
    d1 = torch.where(ok, (g11 * b0 - g01 * b1) / det_safe, minus)
    d2 = torch.where(ok, (g00 * b1 - g01 * b0) / det_safe, minus)
    X1 = d1[..., None] * x1           # foot on ray 1, cam-1 frame
    X2 = _matvec(R.mT, d2[..., None] * x2 - t)   # foot on ray 2
    X = 0.5 * (X1 + X2)
    d1 = torch.where(ok, X[..., 2], d1)
    d2 = torch.where(ok, (_matvec(R, X) + t)[..., 2], d2)
    return X, d1, d2


def recover_pose(E, p1, p2, weights=None):
    """The candidate (R, t) of E (3, 3) with the most points (weighted) in
    front of both cameras (recovery.hpp:95-129; two_view_geometry.cpp:
    61-101), ties to the first. p1, p2 (N, 2). Returns (R, t, n_good,
    X (N, 3) triangulated under the winner, 0 where a point fails)."""
    Rs, ts = decompose_essential(E)
    w = torch.ones_like(p1[:, 0]) if weights is None else weights
    X, d1, d2 = triangulate_midpoint(Rs[:, None], ts[:, None], p1[None],
                                     p2[None])                # (4, N, ...)
    good = (d1 > 0) & (d2 > 0) & torch.isfinite(X).all(dim=-1)
    X = torch.where(good[..., None], X, torch.zeros_like(X))
    scores = (good * w).sum(dim=-1)
    best = torch.argmax(scores)
    return Rs[best], ts[best], scores[best], X[best]
