"""Batched SO3/SE3 primitives on torch tensors.

Port of ``photometric_bundle_adjustment_tpu/core/se3.py``: the same
conventions and the same formulas, over arbitrary leading batch dims.

* A pose is a ``(..., 7)`` tensor ``[tx, ty, tz, qx, qy, qz, qw]``.
* A tangent vector is ``(..., 6)`` = ``[rho(3), phi(3)]``.
* Retraction is right-plus: ``T_new = T * exp(delta)``.

Small-angle branches use ``torch.where`` over safe denominators, as the
reference does, so no branch ever divides by zero.
"""

from __future__ import annotations

import torch


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _safe_div(num, den, small):
    return num / torch.where(small, torch.ones_like(den), den)


def hat_so3(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


# ---------------------------------------------------------------------------
# quaternions (x, y, z, w)
# ---------------------------------------------------------------------------


def quat_identity(dtype=torch.float64) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(x)
    return torch.stack(
        [
            torch.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4).

    The four-candidate construction: each candidate is computed, and the
    one with the largest pivot is taken (the first on ties, as
    ``jnp.argmax``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=0.0)) / 2.0

    qw_ = half_sqrt(1.0 + tr)
    qx_ = half_sqrt(1.0 + m00 - m11 - m22)
    qy_ = half_sqrt(1.0 - m00 + m11 - m22)
    qz_ = half_sqrt(1.0 - m00 - m11 + m22)

    def over(num, q):
        return num / torch.clamp(4 * q, min=1e-30)

    cw = torch.stack([over(m21 - m12, qw_), over(m02 - m20, qw_),
                      over(m10 - m01, qw_), qw_], dim=-1)
    cx = torch.stack([qx_, over(m01 + m10, qx_), over(m02 + m20, qx_),
                      over(m21 - m12, qx_)], dim=-1)
    cy = torch.stack([over(m01 + m10, qy_), qy_, over(m12 + m21, qy_),
                      over(m02 - m20, qy_)], dim=-1)
    cz = torch.stack([over(m02 + m20, qz_), over(m12 + m21, qz_), qz_,
                      over(m10 - m01, qz_)], dim=-1)
    idx = torch.argmax(torch.stack([qw_, qx_, qy_, qz_], dim=-1), dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)          # (..., 4, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO3 exp / log
# ---------------------------------------------------------------------------


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < _eps(phi.dtype) ** 0.5 * 1e-3
    theta2_safe = torch.where(small, torch.zeros_like(theta2), theta2)
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2_safe))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0,
                    _safe_div(torch.sin(half), theta, small))
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([phi * k, w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> axis-angle (..., 3) with angle in [0, pi]."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    qv = q[..., :3]
    w = q[..., 3:4]
    n2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = n2 < _eps(q.dtype) ** 0.5 * 1e-3
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    k_taylor = 2.0 / w - 2.0 * n2 / (3.0 * w**3)
    k_general = _safe_div(2.0 * torch.atan2(n, w), n, small)
    return qv * torch.where(small, k_taylor, k_general)


# ---------------------------------------------------------------------------
# SE3
# ---------------------------------------------------------------------------


def identity(dtype=torch.float64) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype)


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3:7]


def make(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, q], dim=-1)


def from_matrix(M: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) or (..., 3, 4) homogeneous matrix -> (..., 7) pose."""
    return make(M[..., :3, 3], quat_from_matrix(M[..., :3, :3]))


def to_matrix(T: torch.Tensor) -> torch.Tensor:
    """(..., 7) pose -> (..., 4, 4) homogeneous matrix."""
    R = quat_to_matrix(rotation(T))
    top = torch.cat([R, translation(T)[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype,
                          device=T.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def compose(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """T1 * T2."""
    q1, q2 = rotation(T1), rotation(T2)
    t = translation(T1) + quat_rotate(q1, translation(T2))
    return make(t, quat_normalize(quat_mul(q1, q2)))


def inverse(T: torch.Tensor) -> torch.Tensor:
    qinv = quat_conj(rotation(T))
    return make(-quat_rotate(qinv, translation(T)), qinv)


def act(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply pose to points: R p + t.  Broadcasts over leading dims."""
    return quat_rotate(rotation(T), p) + translation(T)


def _v_coeffs(phi: torch.Tensor):
    """Coefficients of V = I + a [phi]x + b [phi]x^2 used by se3 exp."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < _eps(phi.dtype) ** 0.5 * 1e-3
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    _safe_div(1.0 - torch.cos(theta), theta2_safe, small))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    _safe_div(theta - torch.sin(theta), theta2_safe * theta,
                              small))
    return a, b


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 tangent (..., 6) = [rho, phi] -> pose (..., 7)."""
    rho = xi[..., :3]
    phi = xi[..., 3:6]
    q = so3_exp(phi)
    a, b = _v_coeffs(phi)
    Phix = hat_so3(phi)
    Phix_rho = torch.einsum("...ij,...j->...i", Phix, rho)
    Vrho = (rho + a * Phix_rho
            + b * torch.einsum("...ij,...j->...i", Phix, Phix_rho))
    return make(Vrho, q)


def log(T: torch.Tensor) -> torch.Tensor:
    """Pose (..., 7) -> se3 tangent (..., 6) = [rho, phi]."""
    phi = so3_log(rotation(T))
    t = translation(T)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < _eps(T.dtype) ** 0.5 * 1e-3
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    half = 0.5 * theta
    c_general = _safe_div(torch.ones_like(theta2), theta2_safe, small) - \
        _safe_div(torch.cos(half), 2.0 * theta * torch.sin(half), small)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, c_general)
    Phix = hat_so3(phi)
    Phix_t = torch.einsum("...ij,...j->...i", Phix, t)
    rho = (t - 0.5 * Phix_t
           + c * torch.einsum("...ij,...j->...i", Phix, Phix_t))
    return torch.cat([rho, phi], dim=-1)


def right_plus(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Ceres-style manifold plus: T * exp(delta)."""
    return compose(T, exp(delta))


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-normalise the quaternion part (drift control after many
    updates)."""
    return make(translation(T), quat_normalize(rotation(T)))
