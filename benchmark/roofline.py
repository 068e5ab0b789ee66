"""The H100's peaks and the least bytes kernel #1 of the photometric solve
must move.

Peaks are NVIDIA's data sheet for the H100 SXM (dense rates, 700 W):
3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores.

Kernel #1 (the program's ``pba_mega_fused``, CUDA name ``mega_kernel``)
evaluates, for every observation row of a pyramid level, the residuals,
Jacobian and Huber weight of its 8-point patch.  Whatever its layout, it
has to read, once each:

* every observation row the problem defines: anchor camera, target
  camera and landmark (4-byte indices): 12 bytes;
* per landmark that a row names, its anchor pixel (2 float32) and its
  reference patch (8 float32), which all of its rows share: 40 bytes;
* the state: per camera that a row names a pose (7 float32) and affine
  brightness (2), per such landmark an inverse depth (1);
* every texel of the level's float32 images that a bilinear tap of a
  patch point touches, counted once however many taps share it.

It writes nothing that every implementation must write (a layout that
reduces in place writes only the normal equations), so no output is
charged: the bound is a lower bound on the bytes, and the share of it a
kernel reaches can only be understated.  The texels are found by warping
every patch point with the benchmark's own plain arithmetic
(``reference/photometric.MapProblem.warp``), not by the program.
"""

from __future__ import annotations

import torch

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12

ROW_BYTES = 3 * 4
CAMERA_BYTES = 9 * 4
LANDMARK_BYTES = 2 * 4 + 8 * 4 + 4
TEXEL_BYTES = 4


def touched_texels(prob, images_l: torch.Tensor, level: int, cams,
                   rho) -> torch.Tensor:
    """Flat indices (into the level's image stack) of every texel a tap
    of a patch point of a row touches at the state ``(cams (K, 9), rho)``,
    with repeats; ``prob`` a ``reference.photometric.MapProblem``."""
    rows = prob.level_rows(images_l, level)
    uv = prob.warp(cams[rows.anchor], cams[rows.target], rho[rows.landmark],
                   rows.const)
    uv = torch.where(torch.isfinite(uv), uv, torch.zeros_like(uv))
    _, H, W = images_l.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001).floor().long()
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001).floor().long()
    base = rows.target[:, None] * (H * W) + y * W + x
    return torch.stack([base, base + 1, base + W, base + W + 1], dim=-1)


def mega_bytes(prob, images_l: torch.Tensor, level: int, cams, rho) -> int:
    """The least bytes one launch of kernel #1 reads at pyramid ``level``
    and the state ``(cams, rho)``."""
    texels = torch.unique(touched_texels(prob, images_l, level, cams, rho))
    n_rows = prob.anchor.shape[0]
    n_cams = torch.unique(torch.cat([prob.anchor, prob.target])).numel()
    n_lms = torch.unique(prob.landmark).numel()
    return (ROW_BYTES * n_rows + CAMERA_BYTES * n_cams
            + LANDMARK_BYTES * n_lms + TEXEL_BYTES * texels.numel())
