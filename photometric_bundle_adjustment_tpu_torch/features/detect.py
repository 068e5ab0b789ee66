"""Shi-Tomasi corner detection on (B, H, W) image batches.

Port of ``photometric_bundle_adjustment_tpu/features/detect.py``, the
replacement of the reference's ``cv::goodFeaturesToTrack`` call
(include/visnav/keypoints.h:133-149): Sobel gradients, structure tensor
(box filter), minimum-eigenvalue score, edge margin, quality threshold
(a fraction of the best score), window non-maximum suppression, then the
``num_features`` best corners.  Every filter is a zero-padded separable
shift-multiply-add in the JAX package's order of terms, so the scores
agree with it to rounding.

Corners are ordered by score descending and, among equal scores, by flat
pixel index ascending, as ``jax.lax.top_k`` orders them: feature ids then
match the JAX package's, which saved maps refer to.  ``torch.topk`` makes
no such promise, so the order comes from a stable sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EDGE_THRESHOLD = 19  # keypoints.h:51


def shifted(x: torch.Tensor, dim: int, offsets) -> list[torch.Tensor]:
    """Zero-padded shifts of (…, H, W) maps along ``dim`` (-2 or -1):
    [out(p) = x(p + o) for o in offsets], views of one padded copy."""
    r = max(abs(o) for o in offsets)
    xp = F.pad(x, (r, r, 0, 0) if dim == -1 else (0, 0, r, r))
    return [xp.narrow(dim, r + o, x.shape[dim]) for o in offsets]


def conv1d_shift(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Zero-padded 1-D correlation along ``dim`` (-2 or -1) of (…, H, W)
    maps, as a shift-multiply-add over ``taps`` [(offset, weight), ...]:
    out(p) = sum_k w_k * x(p + o_k)."""
    out = None
    for (_, w), xs in zip(taps, shifted(x, dim, [o for o, _ in taps])):
        term = w * xs
        out = term if out is None else out + term
    return out


def shi_tomasi_score(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Min-eigenvalue corner response of (…, H, W) images, float32."""
    img = img.to(torch.float32)
    smooth = [(-1, 0.25), (0, 0.5), (1, 0.25)]   # [1, 2, 1] / 4
    diff = [(-1, -0.5), (1, 0.5)]                # [-1, 0, 1] / 2
    ix = conv1d_shift(conv1d_shift(img, smooth, -2), diff, -1)
    iy = conv1d_shift(conv1d_shift(img, smooth, -1), diff, -2)
    r = block_size // 2
    box = [(o, 1.0) for o in range(-r, r + 1)]
    ixx = conv1d_shift(conv1d_shift(ix * ix, box, -2), box, -1)
    iyy = conv1d_shift(conv1d_shift(iy * iy, box, -2), box, -1)
    ixy = conv1d_shift(conv1d_shift(ix * iy, box, -2), box, -1)
    tr = ixx + iyy
    det_part = torch.sqrt(torch.clamp((ixx - iyy) ** 2 + 4.0 * ixy * ixy,
                                      min=0.0))
    return 0.5 * (tr - det_part)


def _window_max2d(score: torch.Tensor, r: int) -> torch.Tensor:
    """Sliding (2r+1)^2 max of non-negative (…, H, W) maps, as separable
    shifted maxima with zero padding."""

    def axis_max(x, dim):
        out = x
        for xs in shifted(x, dim, [o for o in range(-r, r + 1) if o]):
            out = torch.maximum(out, xs)
        return out

    return axis_max(axis_max(score, -2), -1)


def detect_keypoints(img: torch.Tensor, num_features: int = 1500,
                     quality_level: float = 0.01, min_distance: int = 8,
                     edge_threshold: int = EDGE_THRESHOLD):
    """Detect up to ``num_features`` corners in each of (B, H, W) images
    (uint8 or float), on the images' device.

    Returns uv (B, num_features, 2) float32 corner positions (x = column,
    y = row), valid (B, num_features) bool and score (B, num_features)
    float32.  Defaults match sfm.cpp:197-198 and goodFeaturesToTrack
    (quality 0.01, minimum distance 8), with the edge margin of
    keypoints.h:145."""
    B, H, W = img.shape
    score = shi_tomasi_score(img)
    zero = torch.zeros((), dtype=score.dtype, device=score.device)

    # edge margin first: the zero-padded filters make phantom responses on
    # the border, which must not enter the quality gate's maximum
    ys = torch.arange(H, device=score.device)[:, None]
    xs = torch.arange(W, device=score.device)[None, :]
    in_bounds = ((xs >= edge_threshold) & (xs < W - edge_threshold)
                 & (ys >= edge_threshold) & (ys < H - edge_threshold))
    score = torch.where(in_bounds, score, zero)

    # quality threshold relative to each image's best corner
    best = score.flatten(1).amax(1)[:, None, None]
    score = torch.where(score >= quality_level * best, score, zero)

    # window NMS: keep the maxima of each (2r+1)^2 neighbourhood
    r = max(1, int(min_distance) // 2)
    local_max = _window_max2d(score, r)
    is_peak = (score == local_max) & (score > 0.0)
    masked = torch.where(is_peak, score, zero).flatten(1)

    # score descending, flat index ascending among ties (lax.top_k order)
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    top_scores = top_scores[:, :num_features]
    top_idx = top_idx[:, :num_features]
    uv = torch.stack([(top_idx % W).to(torch.float32),
                      (top_idx // W).to(torch.float32)], dim=-1)
    return uv, top_scores > 0.0, top_scores
