"""Photometric bundle adjustment: problem set-up, samplers and pyramid.

Port of the parts of ``photometric_bundle_adjustment_tpu/models/photometric_ba.py``
that the photometric solve runs.  Residual for one observation (landmark
anchored in reference camera r, seen in target camera t), per patch pixel k:

    r_k = ( I_t(pi_t(warp(uv_r + d_k, rho, T))) - b_t )
          - exp(a_t - a_r) * ( I_r(uv_r + d_k) - b_r )

with an 8-dim camera tangent [se3(6), a, b] and scalar inverse-depth
landmarks.  Images are sampled bilinearly from a flat ``(K*H*W,)`` buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.optim import ba

# DSO residual pattern: 8 pixels around the anchor
PATCH_OFFSETS = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    np.float64,
)
PATCH_SIZE = len(PATCH_OFFSETS)


class PhotometricObs(NamedTuple):
    uv_ref: torch.Tensor      # (O, 2) anchor pixel
    ref_patch: torch.Tensor   # (O, 8) reference intensities at uv_ref + offsets
    target_img: torch.Tensor  # (O,) int64 image index of the target camera
    intr_ref: torch.Tensor    # (O, 8)
    intr_target: torch.Tensor  # (O, 8)


class PhotometricCams(NamedTuple):
    pose: torch.Tensor        # (K, 7)
    affine: torch.Tensor      # (K, 2) = (a, b)


def _bilinear_taps(images_flat, img_idx, uv, H: int, W: int):
    """Clamped bilinear coordinates and the 4 taps from the flat buffer."""
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    base = img_idx.long() * (H * W) + y0.long() * W + x0.long()
    v00 = images_flat[base]
    v01 = images_flat[base + 1]
    v10 = images_flat[base + W]
    v11 = images_flat[base + W + 1]
    return fx, fy, v00, v01, v10, v11


def bilinear_sample_flat(images_flat: torch.Tensor, img_idx: torch.Tensor,
                         uv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear sample I[img_idx](uv) from a flat (K*H*W,) buffer.

    uv: (..., 2) float pixel coordinates (x, y).  Out-of-bounds clamps.
    """
    fx, fy, v00, v01, v10, v11 = _bilinear_taps(images_flat, img_idx, uv, H, W)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def bilinear_sample_and_grad(images_flat: torch.Tensor, img_idx: torch.Tensor,
                             uv: torch.Tensor, H: int, W: int):
    """Bilinear sample + analytic image gradient (dI/du, dI/dv); clamped
    (off-image) samples get zero gradient."""
    fx, fy, v00, v01, v10, v11 = _bilinear_taps(images_flat, img_idx, uv, H, W)
    val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    gx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
    gy = (v10 - v00) * (1 - fx) + (v11 - v01) * fx
    in_x = (uv[..., 0] >= 0.0) & (uv[..., 0] <= W - 1.001)
    in_y = (uv[..., 1] >= 0.0) & (uv[..., 1] <= H - 1.001)
    gx = torch.where(in_x, gx, torch.zeros_like(gx))
    gy = torch.where(in_y, gy, torch.zeros_like(gy))
    return val, gx, gy


def cam_retract(cam: PhotometricCams, delta: torch.Tensor) -> PhotometricCams:
    """8-dim camera tangent [se3(6), da, db], batched over leading dims."""
    return PhotometricCams(
        pose=se3.right_plus(cam.pose, delta[..., :6]),
        affine=cam.affine + delta[..., 6:8],
    )


def build_problem(poses, affine, inv_depth, anchor_cam, target_cam, landmark,
                  uv_ref, ref_patch, target_img, intr_ref, intr_target, valid,
                  fixed_cams, lm_valid=None) -> ba.BAProblem:
    """Assemble a photometric BAProblem; all float arguments are tensors on
    one device, index and mask arguments may be numpy or tensors."""
    device = inv_depth.device

    def idx(x):
        return torch.as_tensor(x, device=device).long()

    def mask(x):
        return torch.as_tensor(x, device=device).bool()

    if lm_valid is None:
        lm_valid = torch.ones(inv_depth.shape, dtype=torch.bool, device=device)
    obs = ba.BAObservations(
        anchor_cam=idx(anchor_cam),
        target_cam=idx(target_cam),
        landmark=idx(landmark),
        aux=PhotometricObs(
            uv_ref=uv_ref,
            ref_patch=ref_patch,
            target_img=idx(target_img),
            intr_ref=intr_ref,
            intr_target=intr_target,
        ),
        valid=mask(valid).to(inv_depth.dtype),
    )
    return ba.BAProblem(
        cam_states=PhotometricCams(pose=poses, affine=affine),
        inv_depth=inv_depth,
        obs=obs,
        fixed_cams=mask(fixed_cams),
        lm_valid=mask(lm_valid),
    )


def extract_ref_patches(images_flat: torch.Tensor, img_idx: torch.Tensor,
                        uv_ref: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Sample the 8-pixel reference patches for all landmarks: (L, 8)."""
    offs = torch.as_tensor(PATCH_OFFSETS, dtype=uv_ref.dtype,
                           device=uv_ref.device)
    uv = uv_ref[:, None, :] + offs[None, :, :]
    return bilinear_sample_flat(images_flat, img_idx[:, None], uv, H, W)


# ---------------------------------------------------------------------------
# image pyramids (coarse-to-fine photometric optimisation)
# ---------------------------------------------------------------------------


def downsample2(images: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsampling of (K, H, W) image stacks."""
    K, H, W = images.shape
    H2, W2 = H // 2, W // 2
    x = images[:, : H2 * 2, : W2 * 2].reshape(K, H2, 2, W2, 2)
    return x.mean(dim=(2, 4))


def build_pyramid(images: torch.Tensor, levels: int = 3):
    """Returns [(images_l, H_l, W_l)] for levels 0..levels-1 (0 = full res)."""
    out = []
    cur = images
    for _ in range(levels):
        _, H, W = cur.shape
        out.append((cur, H, W))
        cur = downsample2(cur)
    return out


def scale_intrinsics(intr: torch.Tensor, level: int) -> torch.Tensor:
    """Intrinsics for pyramid level ``level`` (pixel (0,0) is the center of
    the top-left pixel): f' = f/2^l, c' = (c + 0.5)/2^l - 0.5."""
    s = float(2**level)
    return torch.cat(
        [intr[..., 0:2] / s, (intr[..., 2:4] + 0.5) / s - 0.5, intr[..., 4:]],
        dim=-1,
    )


def scale_problem_to_level(problem: ba.BAProblem, level: int) -> ba.BAProblem:
    """Rescale a level-0 photometric problem's pixel quantities to a coarser
    pyramid level (anchor pixels + both intrinsics); ``ref_patch`` must be
    re-extracted from the level's reference images by the caller."""
    if level == 0:
        return problem
    s = float(2**level)
    aux = problem.obs.aux
    aux = aux._replace(
        uv_ref=(aux.uv_ref + 0.5) / s - 0.5,
        intr_ref=scale_intrinsics(aux.intr_ref, level),
        intr_target=scale_intrinsics(aux.intr_target, level),
    )
    return problem._replace(obs=problem.obs._replace(aux=aux))
