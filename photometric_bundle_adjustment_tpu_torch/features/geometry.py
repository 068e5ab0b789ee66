"""Two-view geometry for the stereo check: the essential matrix of a
relative pose and the epipolar inlier test.

Port of the first part of ``photometric_bundle_adjustment_tpu/features/
geometry.py`` (computeEssential and findInliersEssential,
matching_utils.h:51-79).  Triangulation, ``decompose_essential`` and
``eight_point`` come with the RANSAC slice.
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
