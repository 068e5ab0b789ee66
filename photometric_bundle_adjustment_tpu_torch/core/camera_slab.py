"""Plane-layout camera projection with analytic Jacobians.

Port of ``photometric_bundle_adjustment_tpu/core/camera_slab.py``: every
per-observation quantity is a row of a ``(rows, O)`` tensor (observation
axis last).  ``project_slab`` maps point planes ``(qx, qy, qz)`` plus an
``(8, O)`` intrinsics slab to pixel planes ``(u, v)`` and the six
projection-Jacobian planes ``d(u, v)/d(x, y, z)`` in closed form.
"""

from __future__ import annotations

import torch


def _pinhole(intr, qx, qy, qz):
    fx, fy, cx, cy = intr[0:1], intr[1:2], intr[2:3], intr[3:4]
    iz = 1.0 / qz
    u = fx * qx * iz + cx
    v = fy * qy * iz + cy
    z0 = torch.zeros_like(u)
    J00 = fx * iz
    J02 = -fx * qx * iz * iz
    J11 = fy * iz
    J12 = -fy * qy * iz * iz
    return u, v, (J00, z0, J02), (z0, J11, J12)


def _eucm(intr, qx, qy, qz):
    fx, fy, cx, cy = intr[0:1], intr[1:2], intr[2:3], intr[3:4]
    alpha, beta = intr[4:5], intr[5:6]
    r2 = qx * qx + qy * qy
    d = torch.sqrt(beta * r2 + qz * qz)
    den = alpha * d + (1.0 - alpha) * qz
    id_ = 1.0 / d
    iden = 1.0 / den
    iden2 = iden * iden
    dden_x = alpha * beta * qx * id_
    dden_y = alpha * beta * qy * id_
    dden_z = alpha * qz * id_ + (1.0 - alpha)
    u = fx * qx * iden + cx
    v = fy * qy * iden + cy
    J00 = fx * iden - fx * qx * dden_x * iden2
    J01 = -fx * qx * dden_y * iden2
    J02 = -fx * qx * dden_z * iden2
    J10 = -fy * qy * dden_x * iden2
    J11 = fy * iden - fy * qy * dden_y * iden2
    J12 = -fy * qy * dden_z * iden2
    return u, v, (J00, J01, J02), (J10, J11, J12)


def _ds(intr, qx, qy, qz):
    fx, fy, cx, cy = intr[0:1], intr[1:2], intr[2:3], intr[3:4]
    xi, alpha = intr[4:5], intr[5:6]
    r2 = qx * qx + qy * qy
    d1 = torch.sqrt(r2 + qz * qz)
    w = xi * d1 + qz
    d2 = torch.sqrt(r2 + w * w)
    den = alpha * d2 + (1.0 - alpha) * w
    id1 = 1.0 / d1
    id2 = 1.0 / d2
    iden = 1.0 / den
    iden2 = iden * iden
    dw_x = xi * qx * id1
    dw_y = xi * qy * id1
    dw_z = xi * qz * id1 + 1.0
    dd2_x = (qx + w * dw_x) * id2
    dd2_y = (qy + w * dw_y) * id2
    dd2_z = w * dw_z * id2
    dden_x = alpha * dd2_x + (1.0 - alpha) * dw_x
    dden_y = alpha * dd2_y + (1.0 - alpha) * dw_y
    dden_z = alpha * dd2_z + (1.0 - alpha) * dw_z
    u = fx * qx * iden + cx
    v = fy * qy * iden + cy
    J00 = fx * iden - fx * qx * dden_x * iden2
    J01 = -fx * qx * dden_y * iden2
    J02 = -fx * qx * dden_z * iden2
    J10 = -fy * qy * dden_x * iden2
    J11 = fy * iden - fy * qy * dden_y * iden2
    J12 = -fy * qy * dden_z * iden2
    return u, v, (J00, J01, J02), (J10, J11, J12)


def _kb4(intr, qx, qy, qz):
    fx, fy, cx, cy = intr[0:1], intr[1:2], intr[2:3], intr[3:4]
    k1, k2, k3, k4 = intr[4:5], intr[5:6], intr[6:7], intr[7:8]
    r2 = qx * qx + qy * qy
    safe = r2 > 0.0
    r = torch.sqrt(torch.where(safe, r2, torch.ones_like(r2)))
    ir = 1.0 / r
    n2 = r2 + qz * qz
    in2 = 1.0 / n2
    theta = torch.atan2(r, qz)
    t2 = theta * theta
    dth = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    dd = 1.0 + t2 * (
        3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4))
    )
    s = dth * ir
    dth_dx = dd * qz * in2 * qx * ir
    dth_dy = dd * qz * in2 * qy * ir
    dth_dz = -dd * r * in2
    ds_dx = ir * (dth_dx - s * qx * ir)
    ds_dy = ir * (dth_dy - s * qy * ir)
    ds_dz = ir * dth_dz
    u = torch.where(safe, fx * s * qx + cx, cx.expand_as(r2))
    v = torch.where(safe, fy * s * qy + cy, cy.expand_as(r2))
    # exact-center limit: s -> 1/z, d s/d(x,y) -> 0 (as the reference)
    iz = 1.0 / qz
    zero = torch.zeros_like(r2)
    J00 = torch.where(safe, fx * (s + qx * ds_dx), fx * iz)
    J01 = torch.where(safe, fx * qx * ds_dy, zero)
    J02 = torch.where(safe, fx * qx * ds_dz, zero)
    J10 = torch.where(safe, fy * qy * ds_dx, zero)
    J11 = torch.where(safe, fy * (s + qy * ds_dy), fy * iz)
    J12 = torch.where(safe, fy * qy * ds_dz, zero)
    return u, v, (J00, J01, J02), (J10, J11, J12)


_SLAB_MODELS = {
    "pinhole": _pinhole,
    "eucm": _eucm,
    "ds": _ds,
    "kb4": _kb4,
}


def project_slab(model: str, intr, qx, qy, qz):
    """Project point planes and return pixel planes + Jacobian planes.

    Args:
      model: one of "pinhole", "eucm", "ds", "kb4".
      intr: (8, N) intrinsics slab (rows fx, fy, cx, cy, p4..p7).
      qx, qy, qz: (..., N) point-component planes.

    Returns:
      (u, v, (J00, J01, J02), (J10, J11, J12)) — all shaped like ``qx``.
    """
    try:
        fn = _SLAB_MODELS[model]
    except KeyError:
        raise ValueError(
            f"Camera model {model!r} is not implemented. "
            f"Available: {sorted(_SLAB_MODELS)}"
        ) from None
    return fn(intr, qx, qy, qz)
