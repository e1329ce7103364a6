"""Strapdown INS mechanization in the local-level NED frame (port of
``slam_tricks_tpu/estimation/ins.py``).

Reference: st14-ins/src/src/ins.cpp:6-146: attitude update with
coning-corrected delta-theta and earth / transport-rate quaternions,
velocity update with the Coriolis and gravity integral and the
sculling-corrected specific force, position update by midpoint integration
with the meridian / prime-vertical radii; reference ellipsoids
(ellipsoid.hpp:14-108). ``normal_gravity`` is the Somigliana model with a
height correction.

State: lat / lon / h (rad, rad, m), v_ned (3,), q_nb quaternion
[w, x, y, z] (body -> NED); increments: gyro dtheta (rad) and accel dv
(m/s) a step. The state runs in the caller's dtype: latitude and longitude
in radians against a 6.4e6 m radius need float64. ``mechanize_trajectory``
is a loop over the steps (the JAX package's ``lax.scan``).
"""

from typing import NamedTuple

import torch

from slam_tricks_tpu_torch.manifolds import so3

# Reference ellipsoids (a, f, GM, omega_e), ellipsoid.hpp:14-108
ELLIPSOIDS = {
    "WGS84": dict(a=6378137.0, f=1.0 / 298.257223563,
                  GM=3.986004418e14, omega=7.2921151467e-5),
    "GRS80": dict(a=6378137.0, f=1.0 / 298.257222101,
                  GM=3.986005e14, omega=7.292115e-5),
    "CGCS2000": dict(a=6378137.0, f=1.0 / 298.257222101,
                     GM=3.986004418e14, omega=7.292115e-5),
}


class INSState(NamedTuple):
    lat: torch.Tensor
    lon: torch.Tensor
    h: torch.Tensor
    v_ned: torch.Tensor   # (3,)
    q_nb: torch.Tensor    # (4,) body -> NED


def radii(lat, ell=ELLIPSOIDS["WGS84"]):
    """Meridian (M) and prime-vertical (N) curvature radii."""
    a = ell["a"]
    e2 = ell["f"] * (2.0 - ell["f"])
    s2 = torch.sin(lat) ** 2
    w = torch.sqrt(1.0 - e2 * s2)
    N = a / w
    M = a * (1.0 - e2) / w ** 3
    return M, N


def normal_gravity(lat, h, ell=ELLIPSOIDS["WGS84"]):
    """Somigliana normal gravity with the free-air height correction."""
    ge = 9.7803253359
    k = 0.00193185265241
    e2 = ell["f"] * (2.0 - ell["f"])
    s2 = torch.sin(lat) ** 2
    g0 = ge * (1.0 + k * s2) / torch.sqrt(1.0 - e2 * s2)
    # second-order height correction
    a = ell["a"]
    f = ell["f"]
    m = ell["omega"] ** 2 * a ** 2 * (1 - f) * a / ell["GM"]
    return g0 * (1.0 - 2.0 / a * (1.0 + f + m - 2.0 * f * s2) * h
                 + 3.0 * h ** 2 / a ** 2)


def _quat_mul(q, r):
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _rotvec_quat(phi):
    """Rotation vector -> quaternion (Taylor-safe)."""
    n2 = torch.sum(phi * phi, dim=-1)
    small = n2 < 1e-30
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    half = 0.5 * n
    s = torch.where(small, 0.5 - n2 / 48.0, torch.sin(half) / n)
    return torch.cat([torch.cos(half)[..., None], s[..., None] * phi], dim=-1)


def _earth_rates(lat, h, v_ned, ell):
    """omega_ie^n (earth rate) and omega_en^n (transport rate) in NED."""
    M, N = radii(lat, ell)
    om = ell["omega"]
    w_ie = torch.stack([om * torch.cos(lat), torch.zeros_like(lat),
                        -om * torch.sin(lat)], dim=-1)
    vn, ve = v_ned[..., 0], v_ned[..., 1]
    w_en = torch.stack([ve / (N + h), -vn / (M + h),
                        -ve * torch.tan(lat) / (N + h)], dim=-1)
    return w_ie, w_en


def mechanize_step(state, dtheta, dv, dt, dtheta_prev=None, dv_prev=None,
                   ell=ELLIPSOIDS["WGS84"]):
    """One strapdown update (attitude -> velocity -> position, the
    ins.cpp:37-98 order) with coning / sculling compensation from the
    previous increments."""
    if dtheta_prev is None:
        dtheta_prev = torch.zeros_like(dtheta)
    if dv_prev is None:
        dv_prev = torch.zeros_like(dv)
    cross = torch.linalg.cross

    w_ie, w_en = _earth_rates(state.lat, state.h, state.v_ned, ell)
    w_in = w_ie + w_en

    # attitude: coning-corrected body rotation, nav-frame rotation
    phi_b = dtheta + cross(dtheta_prev, dtheta) / 12.0
    zeta = w_in * dt
    q_b = _rotvec_quat(phi_b)
    q_n = _rotvec_quat(-zeta)
    q_new = _quat_mul(_quat_mul(q_n, state.q_nb), q_b)
    q_new = q_new / torch.linalg.vector_norm(q_new, dim=-1, keepdim=True)

    # velocity: sculling-corrected specific force, Coriolis and gravity
    dv_rot = 0.5 * cross(dtheta, dv)
    dv_scul = (cross(dtheta_prev, dv) + cross(dv_prev, dtheta)) / 12.0
    C_nb = so3.from_quat(state.q_nb)
    # the half-interval nav rotation applied to the integrated force
    eye = torch.eye(3, dtype=dv.dtype, device=dv.device)
    f_n = ((eye - 0.5 * so3.hat(zeta)) @ C_nb
           @ (dv + dv_rot + dv_scul)[..., None])[..., 0]
    g_n = torch.stack([torch.zeros_like(state.lat),
                       torch.zeros_like(state.lat),
                       normal_gravity(state.lat, state.h, ell)], dim=-1)
    cor = cross(2.0 * w_ie + w_en, state.v_ned)
    v_new = state.v_ned + f_n + (g_n - cor) * dt

    # position: midpoint velocity, curvature radii
    v_mid = 0.5 * (state.v_ned + v_new)
    M, N = radii(state.lat, ell)
    h_new = state.h - v_mid[..., 2] * dt
    lat_new = state.lat + v_mid[..., 0] / (M + 0.5 * (state.h + h_new)) * dt
    _, N2 = radii(0.5 * (state.lat + lat_new), ell)
    lon_new = state.lon + v_mid[..., 1] / (
        (N2 + 0.5 * (state.h + h_new))
        * torch.cos(0.5 * (state.lat + lat_new))) * dt
    return INSState(lat=lat_new, lon=lon_new, h=h_new, v_ned=v_new,
                    q_nb=q_new)


def mechanize_trajectory(state0, dthetas, dvs, dt, ell=ELLIPSOIDS["WGS84"]):
    """Mechanize the increments dthetas, dvs (N, 3) in turn; returns the
    stacked INSState history (N,)."""
    state = state0
    prev = (torch.zeros_like(dthetas[0]), torch.zeros_like(dvs[0]))
    hist = []
    for dth, dvv in zip(dthetas, dvs):
        state = mechanize_step(state, dth, dvv, dt, prev[0], prev[1], ell)
        prev = (dth, dvv)
        hist.append(state)
    return INSState(*(torch.stack(f) for f in zip(*hist)))
