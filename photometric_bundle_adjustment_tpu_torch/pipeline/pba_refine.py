"""Photometric refinement of a geometric map.

Port of ``photometric_bundle_adjustment_tpu/pipeline/pba_refine.py``: take
the map (poses + anchored inverse depths) as seed, build the direct
intensity-patch problem over the images, and run the megakernel LM solver
coarse to fine over an image pyramid, in the chunk-plan family (the map's
tracks are heavy-tailed) and, with ``sample_bf16``, the kernel's bf16 tier.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.optim import ba


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
    cam_list = sorted(pipe.cameras)
    cam_index = {f: i for i, f in enumerate(cam_list)}
    lm_list = sorted(pipe.landmarks)

    # image stack: one image per mapped camera, index == camera index
    img0 = next(iter(pipe.images.values()))
    H, W = img0.shape
    K = len(cam_list)
    images = np.zeros((K, H, W), np.float32)
    for f, i in cam_index.items():
        images[i] = pipe.images[f].astype(np.float32)
    images_flat = torch.as_tensor(images.reshape(-1), device=device)

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
    problem = pba.build_problem(
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
    return problem, images_flat, H, W, cam_list, lm_list


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
    iterations, tries, and the set-up and solve seconds (the solve timed
    to a device sync).

    ``sample_bf16`` runs the megakernel's bf16 tier: it samples a bf16 copy
    of each level's image stack, with the taps and all arithmetic in f32."""
    device = devices.resolve(device)
    t0 = time.perf_counter()
    problem, images_flat, H, W, cam_list, lm_list = build_photometric_problem(
        pipe, device=device
    )
    model = pipe.calib.cam_types[0] if pipe.calib.cam_types else "ds"
    cfg = ba.BAConfig(max_iterations=max_iterations, huber_delta=huber_delta,
                      function_tolerance=1e-8, sample_bf16=sample_bf16)

    pyramid = pba.build_pyramid(images_flat.reshape(-1, H, W), levels)
    state = problem
    solved, res = problem, None
    stats = []
    for level in range(levels - 1, -1, -1):
        imgs_l, H_l, W_l = pyramid[level]
        flat_l = imgs_l.reshape(-1)
        prob_l = pba.scale_problem_to_level(state, level)
        # re-extract the reference patches at this level
        aux = prob_l.obs.aux
        patch = pba.extract_ref_patches(
            flat_l, prob_l.obs.anchor_cam, aux.uv_ref, H_l, W_l
        )
        prob_l = prob_l._replace(
            obs=prob_l.obs._replace(aux=aux._replace(ref_patch=patch))
        )
        _sync(device)
        t_setup = time.perf_counter()
        solve = pba_mega.make_mega_solver(
            model, flat_l, H_l, W_l, prob_l, device=device
        )
        _sync(device)
        t_solve = time.perf_counter()
        solved_l, res = solve(prob_l, cfg)
        _sync(device)
        t_end = time.perf_counter()
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
            setup_s=t_solve - t_setup, solve_s=t_end - t_solve,
        ))
        log(
            f"  pba level {level} ({W_l}x{H_l}): cost "
            f"{float(res.initial_cost):.4e} -> {float(res.cost):.4e} "
            f"({res.iterations} it)"
        )
    poses = solved.cam_states.pose.double().cpu().numpy()
    rho = solved.inv_depth.double().cpu().numpy()
    affine = solved.cam_states.affine.cpu().numpy()
    for i, f in enumerate(cam_list):
        pipe.cameras[f] = poses[i]
    for i, t in enumerate(lm_list):
        if rho[i] > 1e-6:  # keep depths sane
            pipe.landmarks[t].inv_depth = float(rho[i])
    pipe.photometric_affine = {f: affine[i] for i, f in enumerate(cam_list)}
    pipe.photometric_levels = stats
    n_obs = int((problem.obs.valid != 0).sum())
    log(
        f"Photometric BA over {len(cam_list)} cameras, {len(lm_list)} "
        f"landmarks, {n_obs} patch observations: cost "
        f"{float(res.initial_cost):.6e} -> {float(res.cost):.6e} in "
        f"{res.iterations} iterations ({time.perf_counter() - t0:.2f}s)"
    )
    return res
