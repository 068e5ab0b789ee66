"""The compile-check step of the flagship model and the multi-rank dry
run, on the card.

The port's counterpart of the JAX package's ``__graft_entry__``:
``entry`` is one forward step of photometric bundle adjustment
(patch-warp intensity residuals, Jacobians by forward mode through the
retraction, the scatter-add normal equations and one Schur-LM step) on
``synth_pba_problem(K=4, L=256)`` in float32; ``dryrun_multichip`` runs
the distributed solvers on a process group at tiny shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.optim import ba


def entry(device="cuda"):
    """``(step, (problem,))``: ``step(problem) -> (cost, delta_c (4, 8),
    delta_p (256,))`` with ``make_ba_step``'s forward-mode Jacobians
    (``rj_fn=None``), Huber 9 and ``schur_solve`` at lambda = 1e-4."""
    problem, images_flat, H, W, _, _ = synthetic.synth_pba_problem(
        K=4, L=256, device=device)
    cfg = ba.BAConfig(max_iterations=1, huber_delta=9.0)
    residual_fn = pba.make_residual_fn("pinhole", images_flat, H, W)
    _, build_neq = ba.make_ba_step(residual_fn, pba.cam_retract, 8)

    def step(problem):
        with ba.full_f32():
            cost, H_cc, H_cp, H_pp, g_c, g_p = build_neq(problem, cfg)
            dc, dp = ba.schur_solve(H_cc, H_cp, H_pp, g_c, g_p, 1e-4,
                                    ~problem.fixed_cams, problem.lm_valid, cfg)
        return cost, dc, dp

    return step, (problem,)


def _check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_rank(comm) -> dict:
    """Rank function of ``dryrun_multichip``: the three paths on this
    rank's shards, each held to a finite (path 4: a falling) cost and to
    bit-equal states across ranks."""
    from photometric_bundle_adjustment_tpu_torch.core import se3
    from photometric_bundle_adjustment_tpu_torch.models import pose_graph as pg
    from photometric_bundle_adjustment_tpu_torch.optim.lm import LMConfig
    from photometric_bundle_adjustment_tpu_torch.parallel import (
        dist_fused,
        dist_pgo,
    )

    D, dev = comm.world, comm.device
    problem, images_flat, H, W, _, _ = synthetic.synth_pba_problem(
        K=4, L=16 * D, device=dev)
    cfg = ba.BAConfig(max_iterations=1, huber_delta=9.0)
    res_fn = pba.make_residual_fn("pinhole", images_flat, H, W)
    sharded = dist_fused.prepare(problem, D)
    shard, plan = sharded.shard(comm.rank, dev)
    out = {}
    # path 1: the replicated solve; path 3: the camera-partitioned PCG
    for name, kw in (("fused", {}), ("partitioned", dict(
            camera_partition=True, n_cg=200, cg_tol=1e-10))):
        solve = dist_fused.make_distributed_fused_solver(
            res_fn, pba.cam_retract, 8, comm, **kw)
        solved, res = solve(shard, plan, cfg)
        _check(bool(torch.isfinite(res.cost)), f"non-finite cost ({name})")
        _check(dist_fused.ranks_bit_equal(comm, solved.cam_states),
               f"ranks not bit-equal ({name})")
        out[name] = (float(res.initial_cost), float(res.cost))

    # path 4: edge-sharded pose-graph optimisation
    rng = np.random.default_rng(0)
    N = 6
    edges = np.array([(i, i + 1) for i in range(N - 1)]
                     + [(0, N - 1), (1, 4), (2, 5)], np.int64)
    T_gt = se3.exp(torch.as_tensor(rng.normal(0, 0.3, (N, 6))
                                   .astype(np.float32), device=dev))
    i, j = edges[:, 0], edges[:, 1]
    graph = pg.PoseGraph(
        edge_i=torch.as_tensor(i), edge_j=torch.as_tensor(j),
        T_ij=se3.compose(se3.inverse(T_gt[i]), T_gt[j]),
        weight=torch.ones(len(edges), dtype=torch.float32))
    T0 = se3.right_plus(T_gt, torch.as_tensor(
        rng.normal(0, 0.05, (N, 6)).astype(np.float32), device=dev))
    fixed = torch.zeros(N, dtype=torch.bool, device=dev)
    fixed[0] = True
    g = dist_pgo.prepare(graph, D).shard(comm.rank, dev)
    poses, (c0, c1, _) = dist_pgo.make_distributed_pgo(comm)(
        T0, g, fixed, LMConfig(max_iterations=15))
    _check(c1 < c0, "distributed PGO did not reduce cost")
    _check(dist_fused.ranks_bit_equal(comm, poses), "ranks not bit-equal (pgo)")
    out["pgo"] = (c0, c1)
    return out


def dryrun_multichip(n_ranks: int, device="cuda", log=print,
                     **spawn_kwargs) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: on
    ``n_ranks`` ranks (``mesh.spawn``, the backend by its rule), one LM
    iteration of the landmark-sharded photometric solve on
    ``synth_pba_problem(K=4, L=16 * n_ranks)`` replicated (path 1) and
    camera-partitioned (path 3), and the edge-sharded pose graph (path 4);
    each cost finite, the pose graph's falling, the ranks bit-equal.
    Path 2 of the JAX function, the GSPMD ``parallel/dist_ba.py``, is a
    duplicate of path 1 and is not ported.  Returns the (initial, final)
    cost of each path.  ``spawn_kwargs`` go to ``mesh.spawn`` (backend,
    timeout, wall limit, threads)."""
    from photometric_bundle_adjustment_tpu_torch.parallel import mesh

    out = mesh.spawn(_dryrun_rank, n_ranks, device=device, log=log,
                     **spawn_kwargs)
    log(f"dryrun_multichip({n_ranks}): distributed photometric-BA LM step "
        f"ok on all three paths: fused cost {out['fused'][0]:.4e} -> "
        f"{out['fused'][1]:.4e}, camera-partitioned PCG cost "
        f"{out['partitioned'][0]:.4e} -> {out['partitioned'][1]:.4e}, "
        f"edge-sharded PGO cost {out['pgo'][0]:.4e} -> {out['pgo'][1]:.4e}")
    return out
