"""Batched camera projection models on torch tensors.

Port of ``photometric_bundle_adjustment_tpu/core/cameras.py``: four models
on a uniform ``(8,)`` parameter vector, selected by name ("pinhole",
"eucm", "ds", "kb4"), broadcasting over leading point dims.

Only the forward pass is ported: nothing on the photometric solve
differentiates through these functions (the warp Jacobian is analytic, in
``core/camera_slab.py``).  The kb4 inverse keeps the reference's 5 fixed
Newton steps; its implicit-function gradient becomes a
``torch.autograd.Function`` when a caller first needs it.
"""

from __future__ import annotations

from typing import Callable

import torch


def _fxy(params):
    return params[..., 0], params[..., 1], params[..., 2], params[..., 3]


# ---------------------------------------------------------------------------
# pinhole
# ---------------------------------------------------------------------------


def pinhole_project(params: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _fxy(params)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([fx * x / z + cx, fy * y / z + cy], dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _fxy(params)
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    v = torch.stack([mx, my, torch.ones_like(mx)], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# extended unified
# ---------------------------------------------------------------------------


def eucm_project(params: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _fxy(params)
    alpha, beta = params[..., 4], params[..., 5]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d = torch.sqrt(beta * (x * x + y * y) + z * z)
    denom = alpha * d + (1.0 - alpha) * z
    return torch.stack([fx * x / denom + cx, fy * y / denom + cy], dim=-1)


def eucm_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _fxy(params)
    alpha, beta = params[..., 4], params[..., 5]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    mz = (1.0 - beta * alpha * alpha * r2) / (
        alpha * torch.sqrt(torch.clamp(1.0 - (2.0 * alpha - 1.0) * beta * r2,
                                       min=0.0))
        + (1.0 - alpha)
    )
    v = torch.stack([mx, my, mz], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# double sphere
# ---------------------------------------------------------------------------


def ds_project(params: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _fxy(params)
    xi, alpha = params[..., 4], params[..., 5]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d1 = torch.sqrt(x * x + y * y + z * z)
    xi_d1_z = xi * d1 + z
    d2 = torch.sqrt(x * x + y * y + xi_d1_z * xi_d1_z)
    denom = alpha * d2 + (1.0 - alpha) * xi_d1_z
    return torch.stack([fx * x / denom + cx, fy * y / denom + cy], dim=-1)


def ds_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _fxy(params)
    xi, alpha = params[..., 4], params[..., 5]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    mz = (1.0 - alpha * alpha * r2) / (
        alpha * torch.sqrt(torch.clamp(1.0 - (2.0 * alpha - 1.0) * r2, min=0.0))
        + 1.0 - alpha
    )
    factor = (mz * xi + torch.sqrt(torch.clamp(mz * mz + (1.0 - xi * xi) * r2,
                                               min=0.0))) / (mz * mz + r2)
    # unnormalised, as in the reference; unproject_unit normalises
    return torch.stack([factor * mx, factor * my, factor * mz - xi], dim=-1)


# ---------------------------------------------------------------------------
# Kannala-Brandt 4
# ---------------------------------------------------------------------------


def _kb4_dtheta(k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    k1, k2, k3, k4 = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    t2 = theta * theta
    return theta + t2 * theta * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))


def _kb4_ddtheta(k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    k1, k2, k3, k4 = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    t2 = theta * theta
    return 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3
                                                          + t2 * 9.0 * k4)))


def kb4_project(params: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _fxy(params)
    k = params[..., 4:8]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r2 = x * x + y * y
    at_center = r2 == 0.0
    r = torch.sqrt(torch.where(at_center, torch.ones_like(r2), r2))
    theta = torch.atan2(r, z)
    d_theta = _kb4_dtheta(k, theta)
    u = torch.where(at_center, cx.expand_as(r2), fx * d_theta * x / r + cx)
    v = torch.where(at_center, cy.expand_as(r2), fy * d_theta * y / r + cy)
    return torch.stack([u, v], dim=-1)


def _kb4_theta_from_ru(k: torch.Tensor, r_u: torch.Tensor) -> torch.Tensor:
    """Solve d(theta) = r_u for theta: 5 Newton steps from 0, as in the
    reference (camera_models.h:372-375)."""
    theta = torch.zeros_like(r_u)
    for _ in range(5):
        theta = theta - (_kb4_dtheta(k, theta) - r_u) / _kb4_ddtheta(k, theta)
    return theta


def kb4_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = _fxy(params)
    k = params[..., 4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    at_center = r2 == 0.0
    r_u = torch.sqrt(torch.where(at_center, torch.ones_like(r2), r2))
    theta = _kb4_theta_from_ru(k, r_u)
    s = torch.sin(theta) / r_u
    x = torch.where(at_center, torch.zeros_like(mx), s * mx)
    y = torch.where(at_center, torch.zeros_like(my), s * my)
    z = torch.where(at_center, torch.ones_like(mx), torch.cos(theta))
    return torch.stack([x, y, z], dim=-1)


# ---------------------------------------------------------------------------
# registry / dispatch
# ---------------------------------------------------------------------------

MODELS: dict[str, tuple[Callable, Callable]] = {
    "pinhole": (pinhole_project, pinhole_unproject),
    "eucm": (eucm_project, eucm_unproject),
    "ds": (ds_project, ds_unproject),
    "kb4": (kb4_project, kb4_unproject),
}


def _lookup(model: str):
    try:
        return MODELS[model]
    except KeyError:
        raise ValueError(
            f"Camera model {model!r} is not implemented. "
            f"Available: {sorted(MODELS)}"
        ) from None


def project(model: str, params: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return _lookup(model)[0](params, p)


def unproject(model: str, params: torch.Tensor,
              uv: torch.Tensor) -> torch.Tensor:
    return _lookup(model)[1](params, uv)


def unproject_unit(model: str, params: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """Unproject and normalise to a unit bearing vector."""
    v = unproject(model, params, uv)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)
