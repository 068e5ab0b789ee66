"""Plane-layout camera projection with analytic Jacobians.

Port of ``photometric_bundle_adjustment_tpu/core/camera_slab.py``: every
per-observation quantity is a row of a ``(rows, O)`` tensor (observation
axis last).  ``project_slab`` maps point planes ``(qx, qy, qz)`` plus an
``(8, O)`` intrinsics slab to pixel planes ``(u, v)`` and the six
projection-Jacobian planes ``d(u, v)/d(x, y, z)`` in closed form.
``warp_slab`` puts the two-camera warp of anchored inverse-depth points in
front of it, with the Jacobian-coefficient planes of both poses and the
inverse depth: the geometry that the photometric megakernel's plain
version and the plane-layout geometric build share.
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


def _rot_planes(q):
    """Unit quaternion rows (N, 4) -> 3x3 list of (N,) rotation entries."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]


def warp_slab(model: str, pa, pc, rho, d3, intr_t):
    """Plane-layout warp of anchored points into their target cameras.

    Column n holds P points of one landmark: unit anchor bearings ``d3``
    (3P, N), rows j*P + p, with P = d3.shape[0] // 3 (8 for a DSO patch, 1
    for a geometric observation), at inverse depth ``rho`` (1, N), seen
    from anchor pose ``pa`` and target pose ``pc`` ((N, 7) rows [t, q]),
    projected with the target intrinsics ``intr_t`` (8, N).  The warped
    point is q = M d + rho u with M = Rc^T Ra and u = Rc^T (ta - tc).

    Returns (ux, uy, GA, GB): the pixel planes (P, N), unmasked, and the
    (13P, N) slabs du/dtheta and dv/dtheta (k-major rows k*P + p, theta_k
    in [t_a(3), phi_a(3), t_c(3), phi_c(3), rho])."""
    P = d3.shape[0] // 3
    Ra = _rot_planes(pa[:, 3:7])
    Rc = _rot_planes(pc[:, 3:7])
    M = [[(Rc[0][j] * Ra[0][c] + Rc[1][j] * Ra[1][c]
           + Rc[2][j] * Ra[2][c])[None, :] for c in range(3)]
         for j in range(3)]
    dt = [pa[:, i] - pc[:, i] for i in range(3)]
    u = [(Rc[0][j] * dt[0] + Rc[1][j] * dt[1] + Rc[2][j] * dt[2])[None, :]
         for j in range(3)]
    d = [d3[j * P:(j + 1) * P] for j in range(3)]             # 3 x (P, N)
    q = [M[j][0] * d[0] + M[j][1] * d[1] + M[j][2] * d[2] + rho * u[j]
         for j in range(3)]
    ux, uy, Jpi0, Jpi1 = project_slab(model, intr_t, q[0], q[1], q[2])

    def coeff(Jp):
        a = [Jp[0] * M[0][c] + Jp[1] * M[1][c] + Jp[2] * M[2][c]
             for c in range(3)]
        blocks = [rho * a[0], rho * a[1], rho * a[2]]
        # dphi_a: d x a
        blocks += [d[1] * a[2] - d[2] * a[1],
                   d[2] * a[0] - d[0] * a[2],
                   d[0] * a[1] - d[1] * a[0]]
        # dt_c: -rho * Jpi
        blocks += [-rho * Jp[0], -rho * Jp[1], -rho * Jp[2]]
        # dphi_c: Jpi x q
        blocks += [Jp[1] * q[2] - Jp[2] * q[1],
                   Jp[2] * q[0] - Jp[0] * q[2],
                   Jp[0] * q[1] - Jp[1] * q[0]]
        # drho: Jpi . u
        blocks += [Jp[0] * u[0] + Jp[1] * u[1] + Jp[2] * u[2]]
        return torch.cat(blocks, dim=0)                       # (13P, N)

    return ux, uy, coeff(Jpi0), coeff(Jpi1)
