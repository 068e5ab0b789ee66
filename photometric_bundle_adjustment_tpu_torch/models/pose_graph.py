"""Pose-graph optimisation: rotation averaging and translation-direction
averaging.

Port of ``photometric_bundle_adjustment_tpu/models/pose_graph.py``, the
reference's global-SfM residuals (include/visnav/global.h:44-86):

  * rotation:     r = log( R_ij * R_wj^-1 * R_wi )          (3-vector)
  * translation:  r = t_hat_ij - (t_wj - t_wi) / (||.|| + 1e-6)

and a full SE3 relative-pose factor for loop-closure graphs.  Edges are
flat tensors; the residuals are plain torch over all edges at once, and
``optim/lm.lm_solve`` solves the dense tangent system (a few hundred
unknowns) on the device of the inputs, in their dtype (f64 in
``pipeline/global_init``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.optim.lm import LMConfig, lm_solve


class RotationGraph(NamedTuple):
    edge_i: torch.Tensor    # (E,) int64
    edge_j: torch.Tensor    # (E,)
    q_ij: torch.Tensor      # (E, 4) measured relative rotations R_i_j
    weight: torch.Tensor    # (E,)


class TranslationGraph(NamedTuple):
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    t_hat_ij: torch.Tensor  # (E, 3) measured unit translation directions
    weight: torch.Tensor


class MetricEdges(NamedTuple):
    """Edges with a known metric relative translation in the world frame
    (calibrated stereo pairs): residual t_j - t_i - t_ij_world.  They
    anchor the global scale that direction-only residuals leave weakly
    constrained."""

    edge_i: torch.Tensor
    edge_j: torch.Tensor
    t_ij_world: torch.Tensor  # (E, 3) metric displacement c_j - c_i
    weight: torch.Tensor


class PoseGraph(NamedTuple):
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    T_ij: torch.Tensor      # (E, 7) measured relative poses T_i_j
    weight: torch.Tensor


def _fixed_mask(fixed, block: int, device) -> torch.Tensor:
    return torch.as_tensor(fixed, device=device).repeat_interleave(block)


def rotation_averaging(quats0: torch.Tensor, graph: RotationGraph, fixed,
                       max_iterations: int = 50, huber_delta: float = 0.05):
    """Returns (quats (N, 4), LMResult).

    Robust by default (Huber on each edge's so3-log block, ~3 deg):
    relative rotations from two-view RANSAC are heavy-tailed, and a few
    wrong-chirality or degenerate edges would otherwise bias every
    camera by degrees."""
    N = quats0.shape[0]

    def residuals(quats):
        q_wi = quats[graph.edge_i]
        q_wj = quats[graph.edge_j]
        q = se3.quat_mul(graph.q_ij, se3.quat_mul(se3.quat_conj(q_wj), q_wi))
        return (se3.so3_log(q) * graph.weight[:, None]).reshape(-1)

    def retract(quats, delta):
        return se3.quat_normalize(
            se3.quat_mul(quats, se3.so3_exp(delta.reshape(N, 3))))

    cfg = LMConfig(max_iterations=max_iterations, function_tolerance=1e-16,
                   huber_delta=huber_delta, block_size=3)
    return lm_solve(residuals, quats0, retract, N * 3, cfg,
                    fixed_mask=_fixed_mask(fixed, 3, quats0.device))


def translation_averaging(t0: torch.Tensor, graph: TranslationGraph, fixed,
                          max_iterations: int = 50,
                          metric: MetricEdges | None = None,
                          huber_delta: float = 0.1):
    """Returns (t (N, 3), LMResult); ``fixed`` needs at least 2 cameras
    (the scale gauge).  Robust by default: two-view directions mean
    nothing for near-zero baselines (errors up to 180 deg).  Metric-edge
    weights should put their converged residual inside the Huber region
    (weight x metres <= huber_delta)."""
    N = t0.shape[0]

    def residuals(t):
        diff = t[graph.edge_j] - t[graph.edge_i]
        n = torch.linalg.norm(diff, dim=-1, keepdim=True) + 1e-6
        r = ((graph.t_hat_ij - diff / n) * graph.weight[:, None]).reshape(-1)
        if metric is not None:
            rm = (t[metric.edge_j] - t[metric.edge_i]
                  - metric.t_ij_world) * metric.weight[:, None]
            r = torch.cat([r, rm.reshape(-1)])
        return r

    def retract(t, delta):
        return t + delta.reshape(N, 3)

    cfg = LMConfig(max_iterations=max_iterations, function_tolerance=1e-16,
                   huber_delta=huber_delta, block_size=3)
    return lm_solve(residuals, t0, retract, N * 3, cfg,
                    fixed_mask=_fixed_mask(fixed, 3, t0.device))


def pose_graph_optimization(poses0: torch.Tensor, graph: PoseGraph, fixed,
                            max_iterations: int = 50):
    """Full SE3 relative-pose graph: r = log(T_ij^-1 * T_wi^-1 * T_wj)."""
    N = poses0.shape[0]

    def residuals(poses):
        T_ij_est = se3.compose(se3.inverse(poses[graph.edge_i]),
                               poses[graph.edge_j])
        r = se3.log(se3.compose(se3.inverse(graph.T_ij), T_ij_est))
        return (r * graph.weight[:, None]).reshape(-1)

    def retract(poses, delta):
        return se3.right_plus(poses, delta.reshape(N, 6))

    cfg = LMConfig(max_iterations=max_iterations, function_tolerance=1e-16)
    return lm_solve(residuals, poses0, retract, N * 6, cfg,
                    fixed_mask=_fixed_mask(fixed, 6, poses0.device))
