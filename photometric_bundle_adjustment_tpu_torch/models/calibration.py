"""Camera calibration: full-batch NLLS over per-frame body poses,
per-camera extrinsics and intrinsics on an AprilGrid sequence.

Port of ``photometric_bundle_adjustment_tpu/models/calibration.py``, the
reference's calibration app (src/calibration.cpp:366-428): one residual
per detected grid corner,

    r = p_2d - pi( T_i_c^-1 * T_w_i^-1 * p_grid_3d )

(ReprojectionCostFunctor, reprojection.h:47-72), with camera 0's
extrinsics held fixed (calibration.cpp:386-388).  All corners of all
frames and cameras are one flat residual vector; ``optim/lm.lm_solve``
takes J with ``torch.func.jacfwd`` through the product-manifold
retraction and solves the dense normal equations (a few hundred
unknowns).  It runs in f64 on the device of ``build_data``'s arrays, the
card by default.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.core import cameras, se3
from photometric_bundle_adjustment_tpu_torch.optim.lm import LMConfig, lm_solve


def aprilgrid_corners_3d(tag_cols: int = 6, tag_rows: int = 6,
                         tag_size: float = 0.088,
                         tag_spacing: float = 0.3) -> np.ndarray:
    """3D corner layout of the 6x6 AprilGrid (aprilgrid.h:39-72): tag t's
    four corners are rows 4t..4t+3."""
    x_off = [0.0, tag_size, tag_size, 0.0]
    y_off = [0.0, 0.0, tag_size, tag_size]
    pts = np.zeros((tag_cols * tag_rows * 4, 3))
    for y in range(tag_cols):
        for x in range(tag_rows):
            tag_id = tag_rows * y + x
            xo = x * tag_size * (1 + tag_spacing)
            yo = y * tag_size * (1 + tag_spacing)
            for i in range(4):
                pts[(tag_id << 2) + i] = [xo + x_off[i], yo + y_off[i], 0.0]
    return pts


class CalibParams(NamedTuple):
    T_w_i: torch.Tensor        # (F, 7) body-to-world per frame
    T_i_c: torch.Tensor        # (num_cams, 7) camera-to-body
    intrinsics: torch.Tensor   # (num_cams, 8)


class CalibData(NamedTuple):
    frame_idx: torch.Tensor    # (R,) int64
    cam_idx: torch.Tensor      # (R,) int64
    p_3d: torch.Tensor         # (R, 3) grid corner position
    uv: torch.Tensor           # (R, 2) detected pixel


def build_data(corners: dict, frame_ids: list, grid3d: np.ndarray, *,
               device="cuda") -> CalibData:
    """Flatten {(frame, cam): {"corners", "corner_ids"}} into arrays on
    ``device``, in (frame, cam) order; ``frame_ids`` maps a frame number to
    its index."""
    device = devices.resolve(device)
    fmap = {f: i for i, f in enumerate(frame_ids)}
    fi, ci, p3, uv = [], [], [], []
    for (frame, cam), d in sorted(corners.items()):
        if frame not in fmap:
            continue
        n = len(d["corner_ids"])
        fi.append(np.full(n, fmap[frame], np.int64))
        ci.append(np.full(n, cam, np.int64))
        p3.append(grid3d[d["corner_ids"]])
        uv.append(d["corners"])

    def put(x):
        return torch.as_tensor(np.concatenate(x), device=device)

    return CalibData(frame_idx=put(fi), cam_idx=put(ci),
                     p_3d=put(p3).to(torch.float64),
                     uv=put(uv).to(torch.float64))


def make_residual_fn(model: str, data: CalibData):
    def residuals(params: CalibParams) -> torch.Tensor:
        T_w_i = params.T_w_i[data.frame_idx]
        T_i_c = params.T_i_c[data.cam_idx]
        intr = params.intrinsics[data.cam_idx]
        p_c = se3.act(se3.inverse(T_i_c),
                      se3.act(se3.inverse(T_w_i), data.p_3d))
        return (data.uv - cameras.project(model, intr, p_c)).reshape(-1)

    return residuals


def make_retract(F: int, num_cams: int):
    """Tangent layout: [F*6 body poses | num_cams*6 extrinsics |
    num_cams*8 intrinsics]."""
    D = F * 6 + num_cams * 6 + num_cams * 8

    def retract(params: CalibParams, delta: torch.Tensor) -> CalibParams:
        d_wi = delta[: F * 6].reshape(F, 6)
        d_ic = delta[F * 6: F * 6 + num_cams * 6].reshape(num_cams, 6)
        d_in = delta[F * 6 + num_cams * 6:].reshape(num_cams, 8)
        return CalibParams(
            T_w_i=se3.right_plus(params.T_w_i, d_wi),
            T_i_c=se3.right_plus(params.T_i_c, d_ic),
            intrinsics=params.intrinsics + d_in,
        )

    return retract, D


def fixed_mask(F: int, num_cams: int,
               optimize_intrinsics: bool = True) -> np.ndarray:
    """Camera 0's extrinsics always fixed (calibration.cpp:386-388)."""
    D = F * 6 + num_cams * 6 + num_cams * 8
    m = np.zeros(D, bool)
    m[F * 6: F * 6 + 6] = True
    if not optimize_intrinsics:
        m[F * 6 + num_cams * 6:] = True
    return m


def calibrate(model: str, data: CalibData, init: CalibParams,
              max_iterations: int = 50):
    """Run the calibration NLLS on the device of ``data``; tolerances
    follow calibration.cpp:410-414 (0.01 eps).  Returns (CalibParams,
    LMResult)."""
    eps = float(torch.finfo(init.T_w_i.dtype).eps)
    F = init.T_w_i.shape[0]
    num_cams = init.T_i_c.shape[0]
    retract, D = make_retract(F, num_cams)
    cfg = LMConfig(max_iterations=max_iterations,
                   function_tolerance=0.01 * eps,
                   gradient_tolerance=0.01 * eps, parameter_tolerance=0.0)
    mask = torch.as_tensor(fixed_mask(F, num_cams), device=data.uv.device)
    return lm_solve(make_residual_fn(model, data), init, retract, D, cfg,
                    fixed_mask=mask)


def projection_gap(model: str, intrinsics, truth, W: int, H: int) -> float:
    """How far ``intrinsics`` ((num_cams, 8)) are from ``truth`` in
    pixels: the largest distance, over every camera and a 32 x 24 grid of
    the W x H image, between a pixel and its true ray (unprojected by
    ``truth``) projected by ``intrinsics``.  The parameters alone can
    mislead: ds trades its focal length against xi."""
    xs, ys = np.meshgrid(np.linspace(0, W - 1, 32), np.linspace(0, H - 1, 24))
    uv = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], 1))
    gap = 0.0
    for k, t in zip(np.asarray(intrinsics), np.asarray(truth)):
        ray = cameras.unproject_unit(model, torch.as_tensor(t), uv)
        d = cameras.project(model, torch.as_tensor(k), ray) - uv
        gap = max(gap, float(d.norm(dim=1).max()))
    return gap
