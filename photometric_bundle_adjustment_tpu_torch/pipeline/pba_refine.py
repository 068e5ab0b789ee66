"""Photometric refinement of a geometric map.

Port of ``photometric_bundle_adjustment_tpu/pipeline/pba_refine.py``: take
the map (poses + anchored inverse depths) as seed, build the direct
intensity-patch problem over the images, and run the megakernel LM solver
coarse to fine over an image pyramid, in the chunk-plan family (the map's
tracks are heavy-tailed) and, with ``sample_bf16``, the kernel's bf16 tier.
``refine_photometric_distributed`` solves the full-resolution problem on
the landmark-sharded solver of ``parallel/dist_fused.py`` instead.

``build_photometric_problem`` and ``refine_photometric`` record spans
(``utils/spans``): ``pba.problem`` (with ``pba.problem.images``, the image
stack made and copied, and ``pba.problem.obs``, the observation tables and
the problem), ``pba.pyramid``, per level ``pba.level.problem``,
``pba.level.plan`` (with ``sample_bf16``, ``pba.level.stack``: the level's
bf16 copy of the image stack) and ``pba.level.solve``, then
``pba.writeback``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.optim import ba
from photometric_bundle_adjustment_tpu_torch.utils.spans import span


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_photometric_problem(pipe, *, device="cuda", dtype=torch.float32):
    """Construct (problem, images_flat, H, W, cam_list, lm_list) on
    ``device`` from any object with .cameras/.landmarks/.corners/.images/
    .calib.

    Cameras, landmarks and observations keep the JAX package's order, but
    are not padded to power-of-two counts: those buckets only bound JAX
    recompiles, and PyTorch compiles nothing per shape."""
    device = devices.resolve(device)
    with span("pba.problem"):
        cam_list = sorted(pipe.cameras)
        cam_index = {f: i for i, f in enumerate(cam_list)}
        lm_list = sorted(pipe.landmarks)

        # image stack: one image per mapped camera, index == camera index
        img0 = next(iter(pipe.images.values()))
        H, W = img0.shape
        with span("pba.problem.images"):
            images = np.zeros((len(cam_list), H, W), np.float32)
            for f, i in cam_index.items():
                images[i] = pipe.images[f].astype(np.float32)
            images_flat = torch.as_tensor(images.reshape(-1), device=device)
        with span("pba.problem.obs"):
            problem = _observations(pipe, cam_list, cam_index, lm_list,
                                    images_flat, H, W, device, dtype)
    return problem, images_flat, H, W, cam_list, lm_list


def _observations(pipe, cam_list, cam_index, lm_list, images_flat, H, W,
                  device, dtype):
    """The map's observation tables, reference patches and problem."""
    K = len(cam_list)
    L = len(lm_list)
    rho = np.zeros(L, np.float64)
    anchor_uv = np.zeros((L, 2))
    anchor_cam_idx = np.zeros(L, np.int64)
    anchor_intr = np.zeros(L, np.int64)
    oa, oc, ol, it_ = [], [], [], []
    for i, t in enumerate(lm_list):
        lm = pipe.landmarks[t]
        a = lm.anchor()
        rho[i] = lm.inv_depth
        anchor_uv[i] = pipe.corners[a]["uv"][lm.obs[a]]
        anchor_cam_idx[i] = cam_index[a]
        anchor_intr[i] = a[1]
        for fcid, _feat in sorted(lm.obs.items())[1:]:
            oa.append(anchor_cam_idx[i])
            oc.append(cam_index[fcid])
            ol.append(i)
            it_.append(fcid[1])
    anchor_uv_t = torch.as_tensor(anchor_uv, dtype=dtype, device=device)
    ref_patch = pba.extract_ref_patches(
        images_flat, torch.as_tensor(anchor_cam_idx, device=device),
        anchor_uv_t, H, W,
    )

    def parr(x):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(-1),
                               device=device)

    intr_tab = torch.as_tensor(np.asarray(pipe.calib.intrinsics), dtype=dtype,
                               device=device)
    obs_l = parr(ol)
    fixed = np.zeros(K, bool)
    for f in [(0, 0), (0, 1)]:
        if f in cam_index:
            fixed[cam_index[f]] = True
    poses = np.stack([pipe.cameras[f] for f in cam_list])
    return pba.build_problem(
        poses=torch.as_tensor(poses, dtype=dtype, device=device),
        affine=torch.zeros((K, 2), dtype=dtype, device=device),
        inv_depth=torch.as_tensor(rho, dtype=dtype, device=device),
        anchor_cam=parr(oa),
        target_cam=parr(oc),
        landmark=obs_l,
        uv_ref=anchor_uv_t[obs_l],
        ref_patch=ref_patch.to(dtype)[obs_l],
        target_img=parr(oc),  # image index == camera index
        intr_ref=intr_tab[parr(anchor_intr[np.asarray(ol, np.int64)])],
        intr_target=intr_tab[parr(it_)],
        valid=np.ones(len(oa), bool),
        fixed_cams=fixed,
        lm_valid=np.ones(L, bool),
    )


def refine_photometric_distributed(pipe, n_ranks: int = 4,
                                   max_iterations: int = 20,
                                   huber_delta: float = 9.0,
                                   compare_single: bool = True,
                                   camera_partition: bool = False,
                                   log=print, *, device="cuda", comm=None):
    """Full-resolution photometric BA of the map in ``pipe`` on the
    landmark-sharded solver (``parallel/dist_fused.py``): the distributed
    analog of the reference's TBB/Ceres threads (src/sfm.cpp:1294-1319,
    map_utils.h:381).  Real maps are heavy-tailed in observations per
    landmark; the ragged chunk-plan layout takes the tail as it is.

    The problem is built on ``device`` (``build_photometric_problem``) and
    sharded on the host (``dist_fused.prepare``); ``n_ranks`` new
    processes solve it (``mesh.spawn``, the backend by its rule).  A
    caller already running in a process group passes its ``comm`` instead
    (every rank calls with the same map).
    ``camera_partition`` selects the partitioned PCG.  With
    ``compare_single``, the single-device fused solve
    (``photometric_ba.make_fused_solver``) runs on the same problem on
    ``device`` and its agreement is returned.

    Writes the distributed solution back into ``pipe`` (poses, inverse
    depths above 1e-6, ``photometric_affine``) and sets
    ``pipe.distributed_stats`` (ranks, backend, valid observations per
    rank, the solve's wall seconds, collectives and their bytes by tag,
    builds, tries, CG iterations, whether the ranks ended bit-equal).
    Returns ``(BAResult, parity dict or None)``."""
    from photometric_bundle_adjustment_tpu_torch.optim import fused
    from photometric_bundle_adjustment_tpu_torch.parallel import (
        dist_fused,
        mesh,
    )

    device = devices.resolve(device if comm is None else comm.device)
    t0 = time.perf_counter()
    problem, images_flat, H, W, cam_list, lm_list = build_photometric_problem(
        pipe, device=device)
    model = pipe.calib.cam_types[0] if pipe.calib.cam_types else "ds"
    cfg = ba.BAConfig(max_iterations=max_iterations, huber_delta=huber_delta,
                      function_tolerance=1e-8)
    D = comm.world if comm is not None else n_ranks
    sharded = dist_fused.prepare(problem, D)
    args = (sharded, dist_fused.Family("photometric", model,
                                       images_flat.cpu(), H, W), cfg,
            camera_partition)
    if comm is not None:
        out = dist_fused.solve_rank(comm, *args)
    else:
        out = mesh.spawn(dist_fused.solve_rank, D, *args, device=device,
                         log=log)
    backend = out["backend"]
    wall = time.perf_counter() - t0
    res = ba.BAResult(
        cost=torch.tensor(out["cost"]),
        initial_cost=torch.tensor(out["initial_cost"]),
        iterations=out["iterations"], lam=out["lam"], tries=out["tries"],
        builds=out["builds"], cg_iterations=out["cg_iterations"])
    log(f"  distributed pba ({D} ranks, {backend}, "
        f"{'partitioned PCG' if camera_partition else 'replicated'}): cost "
        f"{out['initial_cost']:.6e} -> {out['cost']:.6e} "
        f"({out['iterations']} it, {wall:.1f}s)")
    pipe.distributed_stats = dict(
        ranks=D, backend=backend, valid_obs=out["valid_obs"],
        solve_s=out["seconds"], wall_s=wall, calls=out["calls"],
        bytes=out["bytes"], builds=out["builds"], tries=out["tries"],
        cg_iterations=out["cg_iterations"],
        ranks_bit_equal=out["ranks_bit_equal"])

    poses = np.asarray(out["cam_states"].pose, np.float64)
    parity = None
    if compare_single:
        t1 = time.perf_counter()
        solve = pba.make_fused_solver(model, images_flat, H, W, device=device)
        p_s, r_s = solve(problem, fused.plan_for_problem(problem), cfg)
        pose_d = float(np.abs(poses - p_s.cam_states.pose.double().cpu()
                              .numpy()).max())
        cost_rel = abs(out["cost"] - float(r_s.cost)) / max(float(r_s.cost),
                                                            1e-9)
        parity = {
            "cost_dist": out["cost"], "cost_single": float(r_s.cost),
            "cost_rel": cost_rel, "pose_maxdiff": pose_d,
            "iters_dist": out["iterations"], "iters_single": r_s.iterations,
        }
        log(f"  single-device check: cost {float(r_s.cost):.6e} (rel diff "
            f"{cost_rel:.2e}), pose max|d| {pose_d:.2e} "
            f"({time.perf_counter() - t1:.1f}s)")

    # landmark rows are in the padded shard-contiguous order;
    # lm_global_index maps them home
    rho_pad = np.asarray(out["inv_depth"], np.float64)
    gidx = sharded.lm_global_index
    for i, f in enumerate(cam_list):
        pipe.cameras[f] = poses[i]
    for i, t in enumerate(lm_list):
        r = float(rho_pad[gidx[i]])
        if r > 1e-6:
            pipe.landmarks[t].inv_depth = r
    affine = np.asarray(out["cam_states"].affine)
    pipe.photometric_affine = {f: affine[i] for i, f in enumerate(cam_list)}
    return res, parity


def level_problem(state, pyramid, level: int):
    """The problem ``state`` at pyramid ``level`` (``build_pyramid``'s
    list): coordinates scaled, the reference patches extracted again from
    that level's images."""
    imgs_l, H_l, W_l = pyramid[level]
    prob_l = pba.scale_problem_to_level(state, level)
    aux = prob_l.obs.aux
    patch = pba.extract_ref_patches(
        imgs_l.reshape(-1), prob_l.obs.anchor_cam, aux.uv_ref, H_l, W_l
    )
    return prob_l._replace(
        obs=prob_l.obs._replace(aux=aux._replace(ref_patch=patch))
    )


def refine_photometric(pipe, max_iterations: int = 20,
                       huber_delta: float = 9.0, levels: int = 3,
                       sample_bf16: bool = False, log=print, *,
                       device="cuda"):
    """Coarse-to-fine photometric BA seeded from the map in ``pipe``, on
    ``device``; writes refined poses, depths and per-image affine
    brightness back into ``pipe``.  Returns the final (full-resolution)
    BAResult.

    Also sets ``pipe.photometric_levels``: one dict per pyramid level, in
    solve order, with the level's size, initial and final cost, accepted
    iterations, tries, and the set-up, cast and solve seconds: the host
    seconds of the level's ``pba.level.plan``, ``pba.level.stack`` and
    ``pba.level.solve`` spans, each ended by a device sync (``stack_s`` is
    0.0 without ``sample_bf16``, which casts nothing).

    ``sample_bf16`` runs the megakernel's bf16 tier: it samples a bf16 copy
    of each level's image stack, with the taps and all arithmetic in f32.
    The copy is made in the level's plan, under its own span, between two
    syncs, so that the solve holds no cast."""
    device = devices.resolve(device)
    t0 = time.perf_counter()
    problem, images_flat, H, W, cam_list, lm_list = build_photometric_problem(
        pipe, device=device
    )
    model = pipe.calib.cam_types[0] if pipe.calib.cam_types else "ds"
    cfg = ba.BAConfig(max_iterations=max_iterations, huber_delta=huber_delta,
                      function_tolerance=1e-8, sample_bf16=sample_bf16)

    with span("pba.pyramid"):
        pyramid = pba.build_pyramid(images_flat.reshape(-1, H, W), levels)
    state = problem
    solved, res = problem, None
    stats = []
    for level in range(levels - 1, -1, -1):
        imgs_l, H_l, W_l = pyramid[level]
        flat_l = imgs_l.reshape(-1)
        with span("pba.level.problem"):
            prob_l = level_problem(state, pyramid, level)
        _sync(device)
        with span("pba.level.plan") as plan:
            solve = pba_mega.make_mega_solver(
                model, flat_l, H_l, W_l, prob_l, device=device
            )
            stack_s = 0.0
            if sample_bf16:
                _sync(device)
                with span("pba.level.stack") as cast:
                    solve.stack(cfg)
                    _sync(device)
                stack_s = cast.seconds
            _sync(device)
        with span("pba.level.solve") as run:
            solved_l, res = solve(prob_l, cfg)
            _sync(device)
        if level == 0:
            solved = solved_l
        # carry optimised state (poses/affine/depths) to the finer level
        state = state._replace(
            cam_states=solved_l.cam_states, inv_depth=solved_l.inv_depth
        )
        stats.append(dict(
            level=level, H=H_l, W=W_l,
            initial_cost=float(res.initial_cost), cost=float(res.cost),
            iterations=res.iterations, tries=res.tries,
            setup_s=plan.seconds, stack_s=stack_s, solve_s=run.seconds,
        ))
        log(
            f"  pba level {level} ({W_l}x{H_l}): cost "
            f"{float(res.initial_cost):.4e} -> {float(res.cost):.4e} "
            f"({res.iterations} it)"
        )
    with span("pba.writeback"):
        poses = solved.cam_states.pose.double().cpu().numpy()
        rho = solved.inv_depth.double().cpu().numpy()
        affine = solved.cam_states.affine.cpu().numpy()
        for i, f in enumerate(cam_list):
            pipe.cameras[f] = poses[i]
        for i, t in enumerate(lm_list):
            if rho[i] > 1e-6:  # keep depths sane
                pipe.landmarks[t].inv_depth = float(rho[i])
        pipe.photometric_affine = {f: affine[i]
                                   for i, f in enumerate(cam_list)}
    pipe.photometric_levels = stats
    n_obs = int((problem.obs.valid != 0).sum())
    log(
        f"Photometric BA over {len(cam_list)} cameras, {len(lm_list)} "
        f"landmarks, {n_obs} patch observations: cost "
        f"{float(res.initial_cost):.6e} -> {float(res.cost):.6e} in "
        f"{res.iterations} iterations ({time.perf_counter() - t0:.2f}s)"
    )
    return res
