"""SO(3) as 3x3 rotation matrices, batched over any leading dimensions.

Port of ``slam_tricks_tpu/manifolds/so3.py``. Where the JAX module works on
one element and is batched with ``vmap``, every function here takes tangents
of shape (..., 3) and matrices of shape (..., 3, 3). The dtype is the
inputs'.
"""

import torch

from slam_tricks_tpu_torch.device import resolve
from slam_tricks_tpu_torch.manifolds import _coeffs

DIM = 3  # tangent dimension


def _eye_like(w):
    return torch.eye(3, dtype=w.dtype, device=w.device)


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def identity(dtype=torch.float32, device=None):
    return torch.eye(3, dtype=dtype, device=resolve(device))


def hat(w):
    """so(3) hat: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta_sq(w):
    return (w * w).sum(dim=-1)[..., None, None]


def exp(w):
    """Rodrigues: exp(hat(w)) = I + A K + B K^2 with K = hat(w)."""
    theta_sq = _theta_sq(w)
    K = hat(w)
    a = _coeffs.sinc(theta_sq)
    b = _coeffs.cosc(theta_sq)
    return _eye_like(w) + a * K + b * (K @ K)


def to_quat(R):
    """(..., 3, 3) rotation -> (..., 4) unit quaternion [w, x, y, z], w >= 0.

    Branch-free Shepperd: all four candidates, selected by the largest of
    (trace, R00, R11, R22)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-30))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    idx = idx[..., None]
    q = torch.where(idx == 0, q0,
                    torch.where(idx == 1, q1, torch.where(idx == 2, q2, q3)))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def from_quat(q):
    """(..., 4) unit quaternion [w, x, y, z] -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def log(R):
    """Robust SO(3) log through the quaternion: 2 atan2(|v|, qw)/|v| * v,
    accurate near theta = 0 and theta = pi."""
    q = to_quat(R)
    qw, v = q[..., :1], q[..., 1:]
    n_sq = (v * v).sum(dim=-1, keepdim=True)
    small = n_sq < 1e-24
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    scale_taylor = 2.0 / qw - 2.0 * n_sq / (3.0 * qw ** 3)
    scale_closed = 2.0 * torch.atan2(n, qw) / n
    return torch.where(small, scale_taylor, scale_closed) * v


def jl(w):
    """Left Jacobian: Jl = I + B K + C K^2."""
    theta_sq = _theta_sq(w)
    K = hat(w)
    b = _coeffs.cosc(theta_sq)
    c = _coeffs.sincc(theta_sq)
    return _eye_like(w) + b * K + c * (K @ K)


def jl_inv(w):
    """Inverse left Jacobian: Jl^-1 = I - K/2 + E K^2."""
    theta_sq = _theta_sq(w)
    K = hat(w)
    e = _coeffs.jl_inv_coeff(theta_sq)
    return _eye_like(w) - 0.5 * K + e * (K @ K)


def jr(w):
    """Right Jacobian: Jr(w) = Jl(-w)."""
    return jl(-w)


def jr_inv(w):
    return jl_inv(-w)


def mul(Ra, Rb):
    return Ra @ Rb


def inv(R):
    return R.mT


def act(R, p):
    """Rotate points p (..., 3); R broadcasts against p's leading dims."""
    return _matvec(R, p)


def adj(R):
    """The adjoint of SO(3) is the matrix itself."""
    return R


def retract(R, w):
    """Right-perturbation boxplus R exp(w), the reference solvers' update
    convention."""
    return R @ exp(w)


def local(Ra, Rb):
    """boxminus: log(Raᵀ Rb), the inverse of retract."""
    return log(Ra.mT @ Rb)


def project(M):
    """The nearest rotation to M (..., 3, 3), through its SVD."""
    U, _, Vh = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vh)
    ones = torch.ones_like(d)
    return (U * torch.stack([ones, ones, d], dim=-1)[..., None, :]) @ Vh


def random(generator, dtype=torch.float32, shape=(), device=None):
    """Uniform random rotations of batch `shape`, from a normal quaternion
    drawn with `generator` (a torch.Generator, in place of a JAX key)."""
    q = torch.randn(*shape, 4, generator=generator, dtype=dtype,
                    device=generator.device).to(resolve(device))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return from_quat(q * torch.where(q[..., :1] < 0, -1.0, 1.0))
