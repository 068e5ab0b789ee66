"""Plain SE3 and camera-model arithmetic for the benchmark's generators and
its reference solvers.

The benchmark imports nothing of the program under test, so it carries its
own copy of the conventions the program's inputs and outputs use:

* a pose is ``(..., 7)`` = ``[tx, ty, tz, qx, qy, qz, qw]``, camera to
  world;
* a tangent is ``(..., 6)`` = ``[rho(3), phi(3)]`` and the retraction is
  right-plus, ``T * exp(delta)``;
* a camera's parameters are an ``(8,)`` vector: ``fx, fy, cx, cy`` and,
  for the double-sphere model, ``xi, alpha``.

The formulas are written out in the same order of operations as the
published ones the program also follows (Usenko et al., "The Double
Sphere Camera Model", 3DV 2018; Sola et al., "A micro Lie theory", 2018),
so the generators built on them reproduce the program's synthetic inputs
bit for bit on the CPU.
"""

from __future__ import annotations

import torch


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _safe_div(num, den, small):
    return num / torch.where(small, torch.ones_like(den), den)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4)."""
    qv, qw = q[..., :3], q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(x)
    return torch.stack([
        torch.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)], -1),
    ], dim=-2)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < _eps(phi.dtype) ** 0.5 * 1e-3
    theta2_safe = torch.where(small, torch.zeros_like(theta2), theta2)
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2),
                                   theta2_safe))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0,
                    _safe_div(torch.sin(half), theta, small))
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([phi * k, w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> axis-angle (..., 3), angle in [0, pi]."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    qv, w = q[..., :3], q[..., 3:4]
    n2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = n2 < _eps(q.dtype) ** 0.5 * 1e-3
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    k_taylor = 2.0 / w - 2.0 * n2 / (3.0 * w ** 3)
    k_general = _safe_div(2.0 * torch.atan2(n, w), n, small)
    return qv * torch.where(small, k_taylor, k_general)


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3:7]


def compose(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """T1 * T2."""
    q1, q2 = rotation(T1), rotation(T2)
    t = translation(T1) + quat_rotate(q1, translation(T2))
    return torch.cat([t, quat_normalize(quat_mul(q1, q2))], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    qinv = quat_conj(rotation(T))
    return torch.cat([-quat_rotate(qinv, translation(T)), qinv], dim=-1)


def act(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R p + t, broadcast over leading dims."""
    return quat_rotate(rotation(T), p) + translation(T)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 tangent (..., 6) = [rho, phi] -> pose (..., 7)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < _eps(phi.dtype) ** 0.5 * 1e-3
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    _safe_div(1.0 - torch.cos(theta), theta2_safe, small))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    _safe_div(theta - torch.sin(theta), theta2_safe * theta,
                              small))
    Phix = hat(phi)
    Phix_rho = torch.einsum("...ij,...j->...i", Phix, rho)
    Vrho = (rho + a * Phix_rho
            + b * torch.einsum("...ij,...j->...i", Phix, Phix_rho))
    return torch.cat([Vrho, q], dim=-1)


def right_plus(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """T * exp(delta)."""
    return compose(T, exp(delta))


def pose_gap(T1: torch.Tensor, T2: torch.Tensor):
    """Translation distance (m) and rotation angle (rad) between poses,
    elementwise over leading dims."""
    dt = torch.linalg.norm(translation(T1) - translation(T2), dim=-1)
    dq = quat_mul(quat_conj(rotation(T2)), rotation(T1))
    return dt, torch.linalg.norm(so3_log(quat_normalize(dq)), dim=-1)


# ---------------------------------------------------------------------------
# camera models
# ---------------------------------------------------------------------------


def _fxy(params):
    return params[..., 0], params[..., 1], params[..., 2], params[..., 3]


def _pinhole_project(params, p):
    fx, fy, cx, cy = _fxy(params)
    x, y, z = p.unbind(-1)
    return torch.stack([fx * x / z + cx, fy * y / z + cy], dim=-1)


def _pinhole_unproject(params, uv):
    fx, fy, cx, cy = _fxy(params)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    v = torch.stack([mx, my, torch.ones_like(mx)], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _ds_project(params, p):
    fx, fy, cx, cy = _fxy(params)
    xi, alpha = params[..., 4], params[..., 5]
    x, y, z = p.unbind(-1)
    d1 = torch.sqrt(x * x + y * y + z * z)
    xi_d1_z = xi * d1 + z
    d2 = torch.sqrt(x * x + y * y + xi_d1_z * xi_d1_z)
    denom = alpha * d2 + (1.0 - alpha) * xi_d1_z
    return torch.stack([fx * x / denom + cx, fy * y / denom + cy], dim=-1)


def _ds_unproject(params, uv):
    fx, fy, cx, cy = _fxy(params)
    xi, alpha = params[..., 4], params[..., 5]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    mz = (1.0 - alpha * alpha * r2) / (
        alpha * torch.sqrt(torch.clamp(1.0 - (2.0 * alpha - 1.0) * r2,
                                       min=0.0))
        + 1.0 - alpha)
    factor = (mz * xi + torch.sqrt(torch.clamp(
        mz * mz + (1.0 - xi * xi) * r2, min=0.0))) / (mz * mz + r2)
    return torch.stack([factor * mx, factor * my, factor * mz - xi], dim=-1)


_MODELS = {"pinhole": (_pinhole_project, _pinhole_unproject),
           "ds": (_ds_project, _ds_unproject)}


def _model(name: str):
    try:
        return _MODELS[name]
    except KeyError:
        raise ValueError(f"camera model {name!r}: the benchmark knows "
                         f"{sorted(_MODELS)}") from None


def project(model: str, params: torch.Tensor, p: torch.Tensor):
    return _model(model)[0](params, p)


def unproject_unit(model: str, params: torch.Tensor, uv: torch.Tensor):
    """Unit bearing of pixel ``uv``."""
    v = _model(model)[1](params, uv)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


# the reference's test intrinsics of the pinhole model
# (camera_models.h's getTestProjections), which the synthetic BA scene uses
PINHOLE_TEST = (0.5 * 805, 0.5 * 800, 505, 509, 0, 0, 0, 0)
