"""Keypoint orientation and rotated BRIEF-256 descriptors, batched.

Port of ``photometric_bundle_adjustment_tpu/features/describe.py``, the
replacement of computeAngles / computeDescriptors (include/visnav/
keypoints.h:151-213): intensity-centroid orientation over the radius-15
disc, then the 256 sampling pairs of the ORB pattern rotated by the angle
(with the reference's ``round()``, half to even in both libraries) and
compared.  Descriptors are packed into (N, 8) 32-bit words, bit d of word
w being test 32 w + d; the port holds the words as int32 with the JAX
package's uint32 bits.

The pattern ships as ``brief_pattern.npz``, a copy of the JAX package's
(a test holds the two equal).  Every function works on (B, H, W) image
batches on the images' device.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.features import detect

PATCH_SIZE = 31       # keypoints.h:49
HALF_PATCH_SIZE = 15  # keypoints.h:50
PATTERN_FILE = Path(__file__).resolve().parent / "brief_pattern.npz"


@functools.cache
def brief_pattern() -> dict:
    """The 256 ORB sampling pairs: int32 arrays xa, ya, xb, yb."""
    with np.load(PATTERN_FILE) as z:
        return {k: z[k] for k in ("xa", "ya", "xb", "yb")}


def _gather_pixels(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img[b, y, x] with clamping; img (B, H, W), x and y (B, …) integer."""
    B, H, W = img.shape
    flat = (y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).reshape(B, -1)
    return img.reshape(B, -1).gather(1, flat.long()).reshape(x.shape)


def centroid_moment_maps(img: torch.Tensor):
    """Dense intensity-centroid moments over the radius-15 disc of
    (…, H, W) images: m10(p) = sum_disc dx I(p + d), m01 likewise.

    The integer disc {x^2 + y^2 <= 225} is symmetric, so the column (row)
    extent at offset d is yb(d) = floor(sqrt(225 - d^2)) in both
    orientations; centred box sums are built incrementally over the
    half-height.  Out-of-image taps read as zero."""
    img = img.to(torch.float32)
    R = HALF_PATCH_SIZE
    yb = [int(np.sqrt(R * R - d * d)) for d in range(R + 1)]

    def centered_boxes(dim):
        views = detect.shifted(img, dim, range(-R, R + 1))
        out = {0: img}
        acc = img
        for b in range(1, R + 1):
            acc = acc + views[R + b] + views[R - b]
            out[b] = acc
        return out

    colbox = centered_boxes(-2)  # vertical extent, for m10's dx columns
    rowbox = centered_boxes(-1)  # horizontal extent, for m01's dy rows
    m10 = torch.zeros_like(img)
    m01 = torch.zeros_like(img)
    for d in range(1, R + 1):
        fwd, back = detect.shifted(colbox[yb[d]], -1, [d, -d])
        m10 = m10 + d * (fwd - back)
        fwd, back = detect.shifted(rowbox[yb[d]], -2, [d, -d])
        m01 = m01 + d * (fwd - back)
    return m10, m01


def compute_angles(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (B, N) in radians
    (keypoints.h:151-180); img (B, H, W), uv (B, N, 2)."""
    m10, m01 = centroid_moment_maps(img)
    cx = uv[..., 0].to(torch.int32)  # truncation, as the reference's cast
    cy = uv[..., 1].to(torch.int32)
    return torch.atan2(_gather_pixels(m01, cx, cy),
                       _gather_pixels(m10, cx, cy))


def compute_descriptors(img: torch.Tensor, uv: torch.Tensor,
                        angles: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF-256 packed to (B, N, 8) int32 words
    (keypoints.h:182-213); img (B, H, W), uv (B, N, 2), angles (B, N)."""
    img = img.to(torch.float32)
    dev = img.device
    pat = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
           for k, v in brief_pattern().items()}
    cx = uv[..., 0].to(torch.int32)[..., None]
    cy = uv[..., 1].to(torch.int32)[..., None]
    ca = torch.cos(angles)[..., None]
    sa = torch.sin(angles)[..., None]

    def rot_round(px, py):
        rx = torch.round(ca * px - sa * py).to(torch.int32)
        ry = torch.round(sa * px + ca * py).to(torch.int32)
        return rx, ry

    xa, ya = rot_round(pat["xa"], pat["ya"])
    xb, yb = rot_round(pat["xb"], pat["yb"])
    va = _gather_pixels(img, cx + xa, cy + ya)
    vb = _gather_pixels(img, cx + xb, cy + yb)
    bits = (va < vb).to(torch.int64)                        # (B, N, 256)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = (bits.reshape(bits.shape[:-1] + (8, 32)) << shifts).sum(-1)
    # the uint32 bit pattern, as int32
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def detect_and_describe(img: torch.Tensor, num_features: int = 1500,
                        rotate_features: bool = True):
    """Corners, angles and descriptors of one (H, W) image: uv (F, 2),
    valid (F,), angles (F,), desc (F, 8) int32
    (detectKeypointsAndDescriptors, keypoints.h:215-221), through the
    batched path."""
    return tuple(x[0] for x in detect_and_describe_batch(
        img[None], num_features, rotate_features))


def detect_and_describe_batch(imgs: torch.Tensor, num_features: int = 1500,
                              rotate_features: bool = True):
    """Corners, angles and descriptors of (B, H, W) images: uv (B, F, 2)
    float32, valid (B, F) bool, angles (B, F) float32, desc (B, F, 8)
    int32 (detectKeypointsAndDescriptors, keypoints.h:215-221)."""
    uv, valid, _ = detect.detect_keypoints(imgs, num_features=num_features)
    if rotate_features:
        angles = compute_angles(imgs, uv)
    else:
        angles = torch.zeros(uv.shape[:2], dtype=torch.float32,
                             device=uv.device)
    return uv, valid, angles, compute_descriptors(imgs, uv, angles)


def detect_and_describe_all(imgs: torch.Tensor, batch: int = 8,
                            num_features: int = 1500,
                            rotate_features: bool = True):
    """``detect_and_describe_batch`` over (N, H, W) images in sub-batches
    of ``batch``, so that memory holds one sub-batch's filter maps.  The
    JAX package pads N to a multiple of ``batch`` with zero images; here
    the last sub-batch is short instead, with the same results."""
    parts = [detect_and_describe_batch(imgs[s:s + batch], num_features,
                                       rotate_features)
             for s in range(0, imgs.shape[0], batch)]
    return tuple(torch.cat(x) for x in zip(*parts))
