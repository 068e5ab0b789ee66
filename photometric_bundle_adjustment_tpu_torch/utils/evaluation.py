"""Trajectory and map evaluation: absolute trajectory error after
Umeyama alignment, reprojection statistics and the map's counters.

Copy of ``photometric_bundle_adjustment_tpu/utils/evaluation.py``; the
map helpers take a pipeline of either package (``compute_projections``
runs the port's batched reprojection on the pipeline's device).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst ((N, 3) each).

    Returns (scale, R (3, 3), t (3,)) minimising ||dst - (s R src + t)||^2.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(d) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(traj_est: np.ndarray, traj_gt: np.ndarray,
             with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of positions) after alignment."""
    s, R, t = umeyama_alignment(traj_est, traj_gt, with_scale)
    aligned = (s * (R @ traj_est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - traj_gt) ** 2, axis=1))))


def trajectory_from_cameras(cameras: dict, cam_id: int = 0) -> np.ndarray:
    """(N, 3) positions of camera ``cam_id`` ordered by frame id."""
    fcids = sorted(f for f in cameras if f[1] == cam_id)
    return np.stack([np.asarray(cameras[f])[:3] for f in fcids])


def reprojection_stats(pipe) -> dict:
    """Summary statistics over all inlier observations of a pipeline map."""
    res = pipe.compute_projections()
    if res is None:
        return {"count": 0}
    rows, err, _flags = res
    inlier = ~np.fromiter((r[3] for r in rows), bool, len(rows))
    errs = np.asarray(err)[inlier]
    if len(errs) == 0:
        return {"count": 0}
    return {
        "count": int(len(errs)),
        "mean_px": float(errs.mean()),
        "median_px": float(np.median(errs)),
        "p95_px": float(np.percentile(errs, 95)),
        "max_px": float(errs.max()),
    }


def map_stats(pipe) -> dict:
    """The reference's summary() counters (sfm.cpp:1170-1184)."""
    return {
        "cameras": len(pipe.cameras),
        "landmarks": len(pipe.landmarks),
        "observations": sum(len(lm.obs) for lm in pipe.landmarks.values()),
        "outlier_tracks": len(pipe.outlier_tracks),
        "outlier_observations": sum(
            len(lm.outlier_obs) for lm in pipe.landmarks.values()),
    }
