"""Edge-sharded pose-graph optimisation over a process group.

Port of ``photometric_bundle_adjustment_tpu/parallel/dist_pgo.py``.  A pose
graph has no landmarks, so it shards over its edges (the relative-pose
factors): data parallelism over residuals, the analog of observation
sharding in BA and of the reference's per-residual Ceres threads
(map_utils.h:377-383).

  * The edge arrays (i, j, T_ij, weight) are split over the ranks; the
    poses (K, 7) are replicated.
  * Each rank evaluates its edges' residuals and (6 x 12) Jacobians at
    once and accumulates a local (K, K, 6, 6) normal-equation tensor.
  * The only collective per build is one ``psum`` of (cost, H, g), O(K^2)
    and independent of the edge count; each damping retry adds one
    scalar ``psum``.
  * The damped solve runs replicated, so every rank takes the same
    decisions and ends with bit-equal poses.

The residual is ``models/pose_graph.pose_graph_optimization``'s SE3
relative-pose factor (include/visnav/global.h:44-86):

    r_e = weight_e * log( T_ij^-1 * T_wi^-1 * T_wj )   in R^6.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.models.pose_graph import PoseGraph
from photometric_bundle_adjustment_tpu_torch.optim.lm import LMConfig


class ShardedPoseGraph(NamedTuple):
    graph: PoseGraph     # numpy leaves, (D * E_s, ...): rank d holds block d
    n_shards: int

    def shard(self, rank: int, device) -> PoseGraph:
        """Rank ``rank``'s edges as tensors on ``device``."""
        E_s = self.graph.edge_i.shape[0] // self.n_shards
        return PoseGraph(*(torch.as_tensor(x[rank * E_s:(rank + 1) * E_s],
                                           device=device)
                           for x in self.graph))


def prepare(graph: PoseGraph, n_shards: int) -> ShardedPoseGraph:
    """Pad the edge axis to a multiple of ``n_shards``: padding edges get
    weight 0 and identity measurements."""
    D = n_shards
    g = PoseGraph(*(x.detach().cpu().numpy() if torch.is_tensor(x)
                    else np.asarray(x) for x in graph))
    E = g.edge_i.shape[0]
    E_pad = -(-E // D) * D

    def pad(x, fill):
        p = np.full((E_pad - E,) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, p])

    ident = np.zeros(7, g.T_ij.dtype)
    ident[6] = 1.0
    padded = PoseGraph(
        edge_i=pad(g.edge_i.astype(np.int64), 0),
        edge_j=pad(g.edge_j.astype(np.int64), 0),
        T_ij=np.concatenate([g.T_ij, np.tile(ident, (E_pad - E, 1))]),
        weight=pad(g.weight, 0),
    )
    return ShardedPoseGraph(padded, D)


def make_distributed_pgo(comm):
    """Returns ``solve(poses0 (K, 7), graph, fixed (K,) bool, cfg) ->
    (poses, (initial_cost, cost, iterations))`` for this rank's edges
    (``ShardedPoseGraph.shard(comm.rank, comm.device)``), on the poses'
    device.  The LM loop is the JAX package's: at most 8 tries an
    iteration (lambda x10 per reject, / 3 on acceptance, at least
    ``min_lambda``); it stops when no try is accepted or the cost change
    is within ``function_tolerance``; ``iterations`` counts the outer
    iterations run."""

    def solve(poses0: torch.Tensor, g: PoseGraph, fixed,
              cfg: LMConfig = LMConfig()):
        K = poses0.shape[0]
        dtype, dev = poses0.dtype, poses0.device
        m = (~torch.as_tensor(fixed, device=dev)).repeat_interleave(6).to(dtype)
        E = g.edge_i.shape[0]

        def edge_rj(poses):
            """Residuals (E_s, 6) and Jacobians (E_s, 6, 12) of the rank's
            edges: 12 forward-mode passes over the batched residual."""
            T_i, T_j = poses[g.edge_i], poses[g.edge_j]
            T_ij_inv = se3.inverse(g.T_ij)

            def f(d):
                est = se3.compose(se3.inverse(se3.right_plus(T_i, d[:, :6])),
                                  se3.right_plus(T_j, d[:, 6:]))
                return g.weight[:, None] * se3.log(se3.compose(T_ij_inv, est))

            zero = torch.zeros((E, 12), dtype=dtype, device=dev)
            cols = []
            for k in range(12):
                tangent = torch.zeros_like(zero)
                tangent[:, k] = 1.0
                r, dr = torch.func.jvp(f, (zero,), (tangent,))
                cols.append(dr)
            return r, torch.stack(cols, dim=-1)

        def cost_fn(poses):
            r = g.weight[:, None] * se3.log(se3.compose(
                se3.inverse(g.T_ij),
                se3.compose(se3.inverse(poses[g.edge_i]), poses[g.edge_j])))
            return comm.psum(0.5 * torch.sum(r * r), tag="cost")

        def build(poses):
            r, J = edge_rj(poses)
            Ji, Jj = J[:, :, :6], J[:, :, 6:]
            ei, ej = g.edge_i, g.edge_j
            blocks = torch.cat([torch.einsum("eri,erj->eij", a, b)
                                for a, b in ((Ji, Ji), (Ji, Jj), (Jj, Ji),
                                             (Jj, Jj))])
            rows = torch.cat([ei * K + ei, ei * K + ej, ej * K + ei,
                              ej * K + ej])
            H = (torch.zeros((K * K, 36), dtype=dtype, device=dev)
                 .index_add_(0, rows, blocks.reshape(-1, 36)))
            gv = torch.zeros((K, 6), dtype=dtype, device=dev).index_add_(
                0, torch.cat([ei, ej]),
                torch.cat([torch.einsum("eri,er->ei", Ji, r),
                           torch.einsum("eri,er->ei", Jj, r)]))
            _, H, gv = comm.psum(0.5 * torch.sum(r * r), H, gv, tag="build")
            return H.reshape(K, K, 6, 6), gv

        def solve_lam(H, gv, lam):
            Hm = H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
            # gauge: identity rows/cols on fixed tangent directions
            Hm = Hm * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
            d = torch.clamp(torch.diagonal(Hm), 1e-12, 1e32)
            chol, info = torch.linalg.cholesky_ex(Hm + lam * torch.diag(d))
            delta = -torch.cholesky_solve((gv.reshape(-1) * m)[:, None],
                                          chol)[:, 0] * m
            delta = torch.where(info == 0, delta,
                                torch.full_like(delta, math.nan))
            return delta.reshape(K, 6)

        poses = poses0
        init_cost = float(cost_fn(poses0))
        cost_f = init_cost
        lam = float(cfg.init_lambda)
        it = 0
        while it < cfg.max_iterations:
            H, gv = build(poses)
            accepted, tries = False, 0
            while not accepted and tries < 8 and lam <= cfg.max_lambda:
                p_try = se3.right_plus(poses, solve_lam(H, gv, lam))
                c_new = float(cost_fn(p_try))
                tries += 1
                accepted = c_new < cost_f and math.isfinite(c_new)
                if not accepted:
                    lam *= 10.0
            it += 1
            if not accepted:
                break
            small = abs(cost_f - c_new) <= (cfg.function_tolerance
                                            * max(cost_f, 1e-300))
            poses, cost_f = p_try, c_new
            lam = max(lam / 3.0, cfg.min_lambda)
            if small:
                break
        return poses, (init_cost, cost_f, it)

    return solve


def solve_rank(comm, sharded: ShardedPoseGraph, poses0, fixed,
               cfg: LMConfig = LMConfig()) -> dict:
    """Rank function (``mesh.spawn``): solve with this rank's edges from
    ``poses0`` (numpy (K, 7)); returns the poses and (initial cost, cost,
    iterations) as numpy, whether every rank ended with bit-equal poses,
    the collectives by tag, the solve's seconds and this rank's edges of
    nonzero weight."""
    from photometric_bundle_adjustment_tpu_torch.parallel.dist_fused import (
        ranks_bit_equal,
    )

    import time

    g = sharded.shard(comm.rank, comm.device)
    comm.reset_counts()
    t0 = time.perf_counter()
    poses, stats = make_distributed_pgo(comm)(
        torch.as_tensor(poses0, device=comm.device), g,
        torch.as_tensor(fixed, device=comm.device), cfg)
    seconds = time.perf_counter() - t0
    calls, nbytes = dict(comm.calls), dict(comm.bytes)
    return dict(poses=poses.cpu().numpy(), stats=stats,
                ranks_bit_equal=ranks_bit_equal(comm, poses), calls=calls,
                bytes=nbytes, seconds=seconds,
                edges=int((g.weight != 0).sum()))
