"""Two-view geometry: the essential matrix of a relative pose, the
epipolar test, midpoint triangulation and its angular error, the
closed-form decomposition of an essential matrix, and the eight-point
solver.

Port of ``photometric_bundle_adjustment_tpu/features/geometry.py`` (the
OpenGV pieces the reference consumes: computeEssential and
findInliersEssential, matching_utils.h:51-79; triangulation,
map_utils.h:168-191).  Every function works over leading batch axes; a
pose ``T_0_1`` broadcasts against the bearings' leading axes, so a (B, 1,
7) pose serves (B, M, 3) bearings.
"""

from __future__ import annotations

import torch

from photometric_bundle_adjustment_tpu_torch.core import se3


def skew(v: torch.Tensor) -> torch.Tensor:
    """(…, 3) -> (…, 3, 3) cross-product matrix."""
    return se3.hat_so3(v)


def essential_from_pose(T_0_1: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R of the relative pose, translation normalised
    (computeEssential, matching_utils.h:51-60)."""
    t = se3.translation(T_0_1)
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
    R = se3.quat_to_matrix(se3.rotation(T_0_1))
    return skew(t) @ R


def epipolar_inliers(bearings0: torch.Tensor, bearings1: torch.Tensor,
                     E: torch.Tensor, threshold: float = 1e-3) -> torch.Tensor:
    """|x_L^T E x_R| <= threshold per match (findInliersEssential,
    matching_utils.h:62-79); bool mask over the leading dims."""
    err = torch.abs(torch.einsum("...i,ij,...j->...", bearings0, E, bearings1))
    return err <= threshold


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _normalized(p: torch.Tensor) -> torch.Tensor:
    return p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                           min=1e-12)


def triangulate_midpoint(f0: torch.Tensor, f1: torch.Tensor,
                         T_0_1: torch.Tensor) -> torch.Tensor:
    """Midpoint triangulation in frame 0 (OpenGV triangulation::triangulate,
    map_utils.h:177-178): unit bearings f0, f1 (…, 3) in cameras 0 and 1,
    T_0_1 the pose of camera 1 in camera-0 coordinates.  Returns points
    (…, 3) in frame 0."""
    R = se3.quat_to_matrix(se3.rotation(T_0_1))
    t = se3.translation(T_0_1)
    Rf1 = torch.stack([_dot(R[..., i, :], f1) for i in range(3)], dim=-1)
    # least squares on [f0, -Rf1] [l0, l1]^T = t (2x2 normal equations)
    a = _dot(f0, f0)
    b = -_dot(f0, Rf1)
    c = _dot(Rf1, Rf1)
    e0 = _dot(f0, t)
    e1 = -_dot(Rf1, t)
    det = a * c - b * b
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    l0 = (c * e0 - b * e1) / det
    l1 = (a * e1 - b * e0) / det
    p0 = l0[..., None] * f0
    p1 = t + l1[..., None] * Rf1
    return 0.5 * (p0 + p1)


def reprojection_angle_error(f0: torch.Tensor, f1: torch.Tensor,
                             T_0_1: torch.Tensor) -> torch.Tensor:
    """OpenGV's relative-pose SAC error: triangulate, reproject into both
    cameras, (1 - cos a0) + (1 - cos a1)."""
    p0 = triangulate_midpoint(f0, f1, T_0_1)
    p1 = se3.act(se3.inverse(T_0_1), p0)
    return (1.0 - _dot(f0, _normalized(p0))) + (1.0 - _dot(f1, _normalized(p1)))


def _cofactor3(A: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix of (…, 3, 3): rows are cross products of row pairs
    (cof(A) = adj(A)^T; A adj(A) = det(A) I)."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    return torch.stack([torch.linalg.cross(r1, r2, dim=-1),
                        torch.linalg.cross(r2, r0, dim=-1),
                        torch.linalg.cross(r0, r1, dim=-1)], dim=-2)


def _orthonormalize_rows(R: torch.Tensor) -> torch.Tensor:
    """Project near-rotations (…, 3, 3) onto SO(3): row Gram-Schmidt, the
    third row the cross product."""
    r0 = R[..., 0, :]
    r0 = r0 / torch.clamp(torch.linalg.norm(r0, dim=-1, keepdim=True), min=1e-30)
    r1 = R[..., 1, :] - _dot(R[..., 1, :], r0)[..., None] * r0
    r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-30)
    return torch.stack([r0, r1, torch.linalg.cross(r0, r1, dim=-1)], dim=-2)


def decompose_essential(E: torch.Tensor):
    """E (…, 3, 3) -> the 4 candidate relative poses (R (…, 4, 3, 3),
    t (…, 4, 3)), closed form with no SVD.

    For E = [t]_x R with unit singular values, t is the unit left-null
    vector (the largest cross product of column pairs) and
    R = cof(E) - [t]_x E; -E gives the second rotation, and the sign of t
    the other two: the SVD's four candidates U W^(T) V^T, (+-)u3, in the
    JAX package's order.  Inputs only approximately essential get a final
    Gram-Schmidt projection onto SO(3)."""
    # scale to unit nonzero singular values: ||E||_F^2 = 2 for essential
    ss = torch.sum(E * E, dim=(-2, -1), keepdim=True)
    En = E * torch.sqrt(2.0 / torch.clamp(ss, min=1e-30))
    c0, c1, c2 = En[..., :, 0], En[..., :, 1], En[..., :, 2]
    cand = torch.stack([torch.linalg.cross(c0, c1, dim=-1),
                        torch.linalg.cross(c1, c2, dim=-1),
                        torch.linalg.cross(c2, c0, dim=-1)], dim=-2)
    k = torch.argmax(torch.linalg.norm(cand, dim=-1), dim=-1)
    t = torch.gather(cand, -2, k[..., None, None].expand(k.shape + (1, 3)))
    t = t[..., 0, :]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-30)
    cof = _cofactor3(En)
    SE = skew(t) @ En
    Ra = _orthonormalize_rows(cof - SE)
    Rb = _orthonormalize_rows(cof + SE)
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def eight_point(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """Essential matrices (…, 3, 3) with f0^T E f1 = 0 from n >= 8 bearing
    correspondences f0, f1 (…, n, 3), projected to rank 2 with equal
    singular values (SVD: the fallback solver)."""
    A = (f0[..., :, None] * f1[..., None, :]).reshape(f0.shape[:-1] + (9,))
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    E = Vt[..., -1, :].reshape(f0.shape[:-2] + (3, 3))
    U, s, Vt2 = torch.linalg.svd(E)
    s_avg = 0.5 * (s[..., 0] + s[..., 1])
    d = torch.stack([s_avg, s_avg, torch.zeros_like(s_avg)], dim=-1)
    return (U * d[..., None, :]) @ Vt2
