"""Global SfM initialisation: rotation and translation averaging over the
pairwise match graph, then triangulation.

Port of ``photometric_bundle_adjustment_tpu/pipeline/global_init.py``.
The reference carries the averaging residuals
(RotationAveragingCostFunctor / TranslationAveragingCostFunctor,
include/visnav/global.h:44-86) but never wires them into its pipeline;
this bootstrap recovers every connected camera at once from the relative
poses of the match table, then triangulates, and the pipeline's BA
polishes (``apps/sfm --global-init``).

Conventions: a match entry's ``T_i_j`` maps camera-j coordinates to
camera-i coordinates (common_types.h:131-133), so its rotation is the
functor's ``R_i_j`` and its translation is camera j's centre seen from
i; in the world frame the measured direction is ``R_wi @ t_ij / ||.||``.
Metric scale enters through the two fixed cameras of the calibrated
stereo pair (the incremental path's gauge, sfm.cpp:1903) and the metric
stereo edges.

The averaging runs in f64 on the pipeline's device; the spanning trees,
the scale re-anchoring and the triangulation loop follow the JAX
package's order, which is part of the result: the first camera pair that
triangulates a track sets its landmark, and a track that fails is tried
again by later pairs.  ``pipe.global_init_stats`` records each part's
cost, iterations and seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.models import pose_graph as pg


def build_edges(pipe, min_edge_inliers: int = 16):
    """Relative-pose edges (fi, fj, T_i_j (7,), inliers) of the match
    table, in its order."""
    edges = []
    for (fi, fj), md in pipe.matches.items():
        n = len(md["inliers"])
        if n < min_edge_inliers:
            continue
        edges.append((fi, fj, np.asarray(md["T_i_j"], np.float64), n))
    return edges


def _component(edges, root):
    """The cameras connected to ``root`` (depth-first, as the JAX
    package walks its sets)."""
    adj: dict = {}
    for fi, fj, _, _ in edges:
        adj.setdefault(fi, set()).add(fj)
        adj.setdefault(fj, set()).add(fi)
    if root not in adj:
        return None
    seen = {root}
    stack = [root]
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return sorted(seen)


def _rotation_tree(N, root_i, e_np, q_np):
    """Spanning-tree rotations: chain the measured rotations outward from
    the root, sweeping the edge list until nothing changes."""
    quats = torch.tensor([0.0, 0, 0, 1.0], dtype=torch.float64).repeat(N, 1)
    q_t = torch.as_tensor(q_np)
    placed = {root_i}
    changed = True
    while changed:
        changed = False
        for k, (a, b) in enumerate(e_np):
            if a in placed and b not in placed:
                quats[b] = se3.quat_mul(quats[a], q_t[k])      # R_wj = R_wi R_ij
                placed.add(b)
                changed = True
            elif b in placed and a not in placed:
                quats[a] = se3.quat_mul(quats[b], se3.quat_conj(q_t[k]))
                placed.add(a)
                changed = True
    return quats


def _position_tree(t0, placed, e_np, t_world_np):
    """Spanning-tree positions with edge lengths of 0.3 along the measured
    world directions."""
    changed = True
    while changed:
        changed = False
        for k, (a, b) in enumerate(e_np):
            if a in placed and b not in placed:
                t0[b] = t0[a] + 0.3 * t_world_np[k]
                placed.add(b)
                changed = True
            elif b in placed and a not in placed:
                t0[a] = t0[b] - 0.3 * t_world_np[k]
                placed.add(a)
                changed = True
    return t0


def global_initialize(pipe, min_edge_inliers: int = 16,
                      max_iterations: int = 60, log=print):
    """Estimate every camera connected to (0, 0) by averaging, write the
    poses into ``pipe.cameras`` (after ``clear_map``) and triangulate the
    tracks seen by two or more of them.  Returns the mapped fcids."""
    dev = pipe.device
    f64 = torch.float64
    stats: dict = {}
    pipe.global_init_stats = stats
    edges = build_edges(pipe, min_edge_inliers)
    if not edges:
        log("Global init: no usable edges.")
        return []
    root = (0, 0)
    fcids = _component(edges, root)
    if fcids is None:
        log("Global init: reference camera has no edges.")
        return []
    index = {f: i for i, f in enumerate(fcids)}
    N = len(fcids)
    stats.update(cameras=N, edges=len(edges))
    log(f"Global init: {N} cameras in the connected component, "
        f"{len(edges)} edges.")

    ei, ej, q_ij, t_hat_cam, w = [], [], [], [], []
    for fi, fj, T, n in edges:
        if fi not in index or fj not in index:
            continue
        ei.append(index[fi])
        ej.append(index[fj])
        q_ij.append(T[3:7])
        t = T[:3]
        norm = np.linalg.norm(t)
        t_hat_cam.append(t / norm if norm > 1e-9 else t * 0.0)
        w.append(np.sqrt(n))
    e_np = np.stack([np.asarray(ei), np.asarray(ej)], 1)
    q_np = np.stack(q_ij)
    ei_t = torch.as_tensor(np.asarray(ei, np.int64), device=dev)
    ej_t = torch.as_tensor(np.asarray(ej, np.int64), device=dev)
    w_t = torch.as_tensor(np.asarray(w), dtype=f64, device=dev)
    w_t = w_t / torch.mean(w_t)
    t_hat_t = torch.as_tensor(np.stack(t_hat_cam), dtype=f64, device=dev)

    # ---- rotation averaging (global.h:44-63 residuals) ----
    t0_s = time.perf_counter()
    fixed_rot = np.zeros(N, bool)
    fixed_rot[index[root]] = True
    rgraph = pg.RotationGraph(
        edge_i=ei_t, edge_j=ej_t,
        q_ij=torch.as_tensor(q_np, dtype=f64, device=dev), weight=w_t)
    quats_init = _rotation_tree(N, index[root], e_np, q_np)
    quats, rres = pg.rotation_averaging(
        quats_init.to(dev), rgraph, fixed_rot, max_iterations=max_iterations)
    stats["rotation"] = dict(
        initial_cost=float(rres.initial_cost), cost=float(rres.cost),
        iterations=int(rres.iterations), seconds=time.perf_counter() - t0_s)
    log(f"Rotation averaging: cost {float(rres.initial_cost):.4e} -> "
        f"{float(rres.cost):.4e} in {int(rres.iterations)} iterations")

    # ---- translation averaging (global.h:65-86 residuals) ----
    t0_s = time.perf_counter()
    # measured world-frame direction of (c_j - c_i): R_wi @ t_ij
    t_world = se3.quat_rotate(quats[ei_t], t_hat_t)
    tgraph = pg.TranslationGraph(edge_i=ei_t, edge_j=ej_t,
                                 t_hat_ij=t_world, weight=w_t)
    # metric stereo edges: every mapped stereo pair has a known metric
    # relative translation from the calibration
    T_i_c = torch.as_tensor(np.asarray(pipe.calib.T_i_c), dtype=f64)
    t_stereo = se3.translation(se3.compose(se3.inverse(T_i_c[0]), T_i_c[1]))
    mi, mj = [], []
    for f in sorted({f for (f, c) in index}):
        if (f, 0) in index and (f, 1) in index:
            mi.append(index[(f, 0)])
            mj.append(index[(f, 1)])
    metric = None
    if mi:
        mi_t = torch.as_tensor(np.asarray(mi, np.int64), device=dev)
        mj_t = torch.as_tensor(np.asarray(mj, np.int64), device=dev)
        t_m = se3.quat_rotate(quats[mi_t],
                              t_stereo.to(dev).expand(len(mi), 3))
        # weight: ~1 cm of converged stereo error sits at the Huber
        # boundary of translation_averaging (delta 0.1)
        metric = pg.MetricEdges(
            edge_i=mi_t, edge_j=mj_t, t_ij_world=t_m,
            weight=torch.full((len(mi),), 10.0, dtype=f64, device=dev))
    # gauge: camera (0, 0) at the origin, (0, 1) at the calibrated offset
    t0 = np.zeros((N, 3))
    fixed_tr = np.zeros(N, bool)
    fixed_tr[index[root]] = True
    pos_placed = {index[root]}
    if (0, 1) in index:
        t0[index[(0, 1)]] = t_stereo.numpy()
        fixed_tr[index[(0, 1)]] = True
        pos_placed.add(index[(0, 1)])
    t0 = _position_tree(t0, pos_placed, e_np, t_world.cpu().numpy())
    trans, tres = pg.translation_averaging(
        torch.as_tensor(t0, device=dev), tgraph, fixed_tr,
        max_iterations=max_iterations, metric=metric)
    log(f"Translation averaging: cost {float(tres.initial_cost):.4e} -> "
        f"{float(tres.cost):.4e} in {int(tres.iterations)} iterations")
    trans_stats = [dict(initial_cost=float(tres.initial_cost),
                        cost=float(tres.cost),
                        iterations=int(tres.iterations))]

    # Direction-only residuals leave the global scale weakly constrained
    # (the solve can settle in a uniformly rescaled local optimum):
    # re-anchor it by the median measured stereo baseline, then re-polish
    trans_np = trans.cpu().numpy()
    if (0, 1) in index:
        calib_baseline = float(np.linalg.norm(t0[index[(0, 1)]]))
        frames = sorted({f for (f, c) in index})
        measured = [
            np.linalg.norm(trans_np[index[(f, 1)]] - trans_np[index[(f, 0)]])
            for f in frames if (f, 0) in index and (f, 1) in index]
        if measured and calib_baseline > 0:
            scale = calib_baseline / float(np.median(measured))
            if abs(scale - 1.0) > 1e-3:
                log(f"Global init: re-anchoring scale by x{scale:.4f} "
                    f"(median stereo baseline {np.median(measured):.4f} m "
                    f"vs calibrated {calib_baseline:.4f} m)")
                trans_rescaled = trans_np * scale
                trans_rescaled[index[root]] = 0.0
                trans_rescaled[index[(0, 1)]] = t0[index[(0, 1)]]
                trans, tres = pg.translation_averaging(
                    torch.as_tensor(trans_rescaled, device=dev), tgraph,
                    fixed_tr, max_iterations=max_iterations, metric=metric)
                trans_np = trans.cpu().numpy()
                trans_stats.append(dict(
                    initial_cost=float(tres.initial_cost),
                    cost=float(tres.cost), iterations=int(tres.iterations),
                    scale=scale))
                log("Translation averaging (rescaled): cost "
                    f"{float(tres.initial_cost):.4e} -> "
                    f"{float(tres.cost):.4e} in {int(tres.iterations)} "
                    "iterations")
    stats["translation"] = dict(solves=trans_stats,
                                seconds=time.perf_counter() - t0_s)

    poses = np.concatenate([trans_np, quats.cpu().numpy()], axis=1)
    pipe.clear_map()
    for f, i in index.items():
        pipe.cameras[f] = poses[i]

    # triangulate every track seen by >= 2 mapped cameras through the
    # pipeline's parallax-gated pairwise triangulation, pair by pair
    t0_s = time.perf_counter()
    n_new = 0
    cams = list(pipe.cameras)
    for a_i in range(len(cams)):
        for b_i in range(a_i + 1, len(cams)):
            n_new += pipe.add_landmarks_between(cams[a_i], cams[b_i])
    stats["triangulation"] = dict(
        pairs=len(cams) * (len(cams) - 1) // 2, landmarks=n_new,
        seconds=time.perf_counter() - t0_s)
    log(f"Global init: triangulated {n_new} landmarks.")
    return fcids
