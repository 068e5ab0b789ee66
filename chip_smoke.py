#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, sm_90a), nvcc, and this checkout; imports no
JAX.  Phases, each of which raises (exit code 1) on failure:

  0. print the card's name and power limit; build the CUDA kernels from
     ``photometric_bundle_adjustment_tpu_torch/csrc`` (one nvcc each, all
     started together) and time the build; print each Hamming kernel
     instance's registers, spills and tensor-core instruction count (from
     ``cuobjdump``) and its shared memory; measure the card's sustained
     mma.sync rate in the b1 and s8 forms (``csrc/mma_rate.cu``);
  1. the megakernel against its plain PyTorch version on the card, at
     EuRoC scale (164 images of 480x752, ~4.8k landmarks, ~30k
     observations, some warped off the image, one non-finite) and on a
     small image 8448 pixels wide; both timed on the device (CUDA
     graphs of 20 calls), the kernel also through its wrapper;
  2. the photometric path: ``refine_photometric`` on a synthetic
     EuRoC-scale map (3 pyramid levels, 20 iterations, Huber 9), checking
     that the cost falls at every level, that the result is finite, that
     the pose error against ground truth shrank and that every kernel of
     the path ran;
  3. the SfM front end at EuRoC V1's size (82 stereo frames, 164 images of
     480x752, 1500 detection slots): ``SfmPipeline.detect_keypoints``,
     ``match_stereo`` and ``pair_matching.match_pairs`` over the whole
     13,284-pair worklist with ``match.matches_to_pairs`` on the card
     (held equal to the host's ``compact_matches_np``), checking the
     corner counts, detection and description against the CPU plain
     path, the stereo inliers against the rendered ground truth, and the
     Hamming kernel's launches on the path (one per ``match_batch``: both
     directions from one distance tile); then ``best_two_both`` over the
     whole worklist bit for bit against its plain version and a
     ``torch._int_mm`` form, all three timed with CUDA events;
  4. the patch sampler and the two kernel-sampled fused solvers:
     (a) the sampler kernel against its plain version at EuRoC scale, on
     the ``imagesort_problem`` layout of phase 2's map at level 0 with the
     warped level-0 coordinates (some pushed off the image, one at -1e6),
     timed on the device (CUDA graphs of 20 calls) beside one
     ``grid_sample`` call, the kernel also through its wrapper; (b)
     ``make_kernel_fused_solver`` on that map from its initial state (20
     iterations, Huber 9, the classic loop), checking that the cost falls,
     the result is finite, the pose error shrank, the first build equals
     the gather solver's on the card and the sampler launched once per
     build and residual pass; (c) ``make_kernel_dense_solver`` on
     ``euroc_scale_pba`` in the slot-major layout (20 iterations, Huber 9,
     the fused-cost loop), with the same checks but the pose error;
  5. the dense slot-major megakernel family and the kernel's bf16 tier on
     ``euroc_scale_pba`` at full size (164 noise images of 480x752, 24,000
     observations in 6 x 4,800 slot rows): (a) the dense family's first
     build and damped solve against the chunk family's on the same
     problem; (b) the bf16 kernel against its plain version on the widened
     stack, timed on the device beside its plain version and the f32
     kernel on the same inputs; (c) ``make_mega_solver(..., plan_slot)`` in
     f32 and in bf16 (20 iterations, Huber 9, the fused-cost loop),
     checking that the cost falls and stays finite and that the
     megakernel launched once per build, with LM it/s and peak memory;
     (d) ``refine_photometric(sample_bf16=True)`` on the initial phase-2
     map, checking the cost at every level and the pose error;
  6. the probes: every variant of the grid-overhead probe
     (``scripts.grid_overhead.run``: 11 variants, each against its plain
     version and timed on the device, printed beside the output-only
     variant) and the window read (``scripts.exp_roll``: the script's call
     at B = 1, then B = 4,096 tiles in each mode, bit for bit against the
     plain version, timed beside one ``torch.roll``).

Then it prints one JSON line describing the six kernels (the megakernel's
f32 and bf16 entries, the Hamming best-two, the patch sampler, the grid
probe and the window read), the card line again, and as the last line
``{"ok": true, "device": {...}}``.

Without CUDA it exits with code 2 and prints no result.

Bounds (``bound_ms``) are reckoned from this run's inputs against the
H100 SXM's published peaks at 700 W: 3.35 TB/s of device memory, 67
TFLOP/s of f32 outside the tensor cores and 1,979 TOP/s of dense int8
tensor-core operations.  The data sheet gives no rate for b1 products,
so the Hamming bound takes the faster of the int8 peak and the b1 rate
phase 0 measured.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

LEVELS, MAX_ITERATIONS, HUBER = 3, 20, 9.0
# The kernel contracts a*b + c into FMAs (nvcc's default), the plain
# version does not: about one ulp per operation.  The residual
# r = (I_t - b_t) - e (I_ref - b_r) cancels operands of image scale, so its
# error is a few ulps of the largest intensity, not of r; the cost
# 0.5 rho(|r|^2) then moves by sum_p |w r_p| times that.  Each observation's
# cost is held at COST_RTOL relative plus COST_FMA_ULPS ulps of the image
# scale times sum_p |r_p sw| (>= sum_p |w r_p|, as sw <= 1).
COST_RTOL = 1e-5
COST_FMA_ULPS = 8
ROWS_ATOL = 1e-4        # times max|ref| of each row block

H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1.979e15
H100_F32_OPS_PER_S = 67e12
# megakernel f32 operations per observation, counted from
# csrc/pba_mega.cu: per patch pixel about 40 for the bilinear value and
# gradient, 68 for J = gx GA + gy GB and about 10 for the residual and
# weight (8 pixels: about 950), plus about 550 for the payloads A0 and
# A1; rounded up
MEGA_OPS_PER_OBS = 2048

# the patch sampler against its plain version: a few ulps of the image
# scale (FMA contraction), as the megakernel's rows
SAMPLE_ATOL = 1e-4      # times max|image|
# the kernel solvers' first build against the gather solver's on the card:
# the ROADMAP's parity tolerances (cost rtol, pieces atol x max|ref|, rtol)
NEQ_TOL = (2e-4, 3e-3, 2e-3)
NEQ_NAMES = ["H_cc", "S_corr0", "rhs_corr0", "H_pp", "g_c", "g_p", "M",
             "inv0"]

# the front end at EuRoC V1's size (bench.py's 82 stereo frames)
FRONT_FRAMES, FRONT_H, FRONT_W = 82, 480, 752
CORNERS_MEDIAN = (300, 500)
GT_PX, GT_SHARE = 2.0, 0.8
# detection on the card against the CPU plain path, as in the tests:
# corners identical; angles to 1e-4 rad; descriptor bits may flip only
# where cos/sin differ by an ulp and a rotated tap lands on .5
CHECK_IMAGES, ANGLE_ATOL, BIT_FLIP_SHARE = 4, 1e-4, 5e-4


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def reset_counts():
    """Set every kernel's launch count to 0."""
    from photometric_bundle_adjustment_tpu_torch.ops import (
        hamming,
        patch_sample,
        pba_mega,
    )
    from photometric_bundle_adjustment_tpu_torch.scripts import (
        exp_roll,
        grid_overhead,
    )

    pba_mega.KERNEL_LAUNCHES = 0
    pba_mega.KERNEL_LAUNCHES_BF16 = 0
    hamming.KERNEL_LAUNCHES = 0
    patch_sample.KERNEL_LAUNCHES = 0
    grid_overhead.KERNEL_LAUNCHES = 0
    exp_roll.KERNEL_LAUNCHES = 0


def timed_pair(kernel, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two ``graph_ms`` readings
    (a CUDA graph of 20 calls each) taken in the order
    plain/kernel/kernel/plain."""
    from photometric_bundle_adjustment_tpu_torch.profile_solve import graph_ms

    p = [graph_ms(plain)]
    k = [graph_ms(kernel), graph_ms(kernel)]
    p.append(graph_ms(plain))
    return float(np.mean(k)), float(np.mean(p))


def pose_errors(cameras: dict, poses_gt: dict, se3):
    """Mean translation (m) and rotation (rad) error of each camera against
    ground truth."""
    keys = sorted(poses_gt)
    T = torch.as_tensor(np.stack([cameras[k] for k in keys]))
    G = torch.as_tensor(np.stack([poses_gt[k] for k in keys]))
    xi = se3.log(se3.compose(se3.inverse(G), T))
    return float(xi[:, :3].norm(dim=1).mean()), float(xi[:, 3:].norm(dim=1).mean())


def compare_payloads(out, ref, images, label: str) -> float:
    """Kernel payload against the plain version's; returns max |err| over
    the finite entries.  NaN columns (non-finite projections) must match.
    ``images`` sets the intensity scale of the cost row's FMA bound."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega

    cost_k, cost_r = out[pba_mega.ROW_COST], ref[pba_mega.ROW_COST]
    nan_k, nan_r = torch.isnan(cost_k), torch.isnan(cost_r)
    check(bool((nan_k == nan_r).all()), f"{label}: NaN columns differ")
    ok = ~nan_r
    check(bool(torch.isfinite(out[:, ok]).all()), f"{label}: non-finite output")
    rel = ((cost_k[ok] - cost_r[ok]).abs()
           / cost_r[ok].abs().clamp_min(1e-30)).max()
    total_rel = abs(float(cost_k[ok].double().sum() - cost_r[ok].double().sum())
                    ) / max(float(cost_r[ok].double().sum()), 1e-30)
    max_err, blocks = 0.0, []
    for name, rows in [("J", slice(0, 136)), ("r*sw", slice(136, 144)),
                       ("A0", slice(145, 162)), ("A1", slice(162, 179)),
                       ("pad", slice(179, 184))]:
        a, b = out[rows][:, ok], ref[rows][:, ok]
        err = float((a - b).abs().max())
        scale = max(float(b.abs().max()), 1e-6)
        check(err <= ROWS_ATOL * scale,
              f"{label}: rows {name} max err {err} > {ROWS_ATOL} * {scale}")
        max_err = max(max_err, err)
        blocks.append(f"{name} {err:.2e}/{scale:.2e}")
    # per-observation cost: rtol plus the FMA bound of the residual
    cost_err = (cost_k[ok] - cost_r[ok]).abs()
    ulp_img = torch.finfo(torch.float32).eps * float(images.abs().max())
    r_l1 = ref[136:144][:, ok].abs().sum(dim=0)
    bound = COST_RTOL * cost_r[ok].abs() + COST_FMA_ULPS * ulp_img * r_l1
    worst = float((cost_err / bound.clamp_min(1e-30)).max())
    check(worst <= 1.0, f"{label}: cost row beyond rtol {COST_RTOL} + "
          f"{COST_FMA_ULPS} ulps of the image scale ({worst:.3f} of bound)")
    check(total_rel <= COST_RTOL, f"{label}: total cost rel err {total_rel}")
    max_err = max(max_err, float(cost_err.max()))
    print(f"  {label}: {int(ok.sum())} finite columns, {int(nan_r.sum())} NaN; "
          f"max|err| {max_err:.3e}, cost max rel {float(rel):.3e}, "
          f"total cost rel {total_rel:.3e}, cost err {worst:.3f} of bound")
    print(f"    max|err| / max|ref| per row block: {', '.join(blocks)}")
    return max_err


def mega_bound_ms(args) -> float:
    """Least time of one megakernel build on these inputs: the bytes it
    must move (each valid observation's slabs and each image pixel its
    taps touch read once, at the stack's 4 or 2 bytes, the (184, Og)
    output written once) over the card's memory rate.  Its f32 operations
    (MEGA_OPS_PER_OBS each) take far less, so it is bytes-bound."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega

    images, ux, uy, GA, GB, refp, aff, iog, cnt, _ = args
    K, H, W = images.shape
    Og = ux.shape[1]
    G = pba_mega.GROUP
    lane = torch.arange(Og, device=ux.device) % G
    ok = lane < cnt.long().repeat_interleave(G)
    n_obs = int(ok.sum())
    slab_rows = ux.shape[0] + uy.shape[0] + GA.shape[0] + GB.shape[0] \
        + refp.shape[0] + aff.shape[0]
    img = iog.long().repeat_interleave(G)[ok]
    x0 = torch.floor(ux[:, ok]).clamp(-1, W - 1).long()
    y0 = torch.floor(uy[:, ok]).clamp(-1, H - 1).long()
    taps = torch.cat([((img * H + (y0 + dy).clamp(0, H - 1)) * W
                       + (x0 + dx).clamp(0, W - 1)).reshape(-1)
                      for dy in (0, 1) for dx in (0, 1)])
    n_pix = int(torch.unique(taps).numel())
    texel = images.element_size()
    nbytes = 4 * (slab_rows * n_obs + 2 * iog.numel()) + texel * n_pix \
        + 4 * pba_mega.OUT_ROWS * Og
    ops = MEGA_OPS_PER_OBS * n_obs
    check(ops / H100_F32_OPS_PER_S < nbytes / H100_BYTES_PER_S,
          "megakernel bound is not bytes")
    print(f"  bound: {nbytes / 1e6:.2f} MB ({n_obs} observations x "
          f"{4 * slab_rows} B, {n_pix} image pixels x {texel} B, output "
          f"{4 * pba_mega.OUT_ROWS * Og / 1e6:.2f} MB) at 3.35 TB/s")
    return 1e3 * nbytes / H100_BYTES_PER_S


def kernel_phase(pipe, device):
    """Phase 1: the kernel against the plain version at EuRoC scale and on
    an 8448-pixel-wide image.  Returns (max_abs_err, ms, plain_ms,
    bound_ms)."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        SEED,
        time_ms,
    )

    problem, images_flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe, device=device)
    K = problem.cam_states.pose.shape[0]
    model = pipe.calib.cam_types[0]
    solve = pba_mega.make_mega_solver(model, images_flat, H, W, problem, K,
                                      device=device)
    consts = solve.consts
    ux, uy, _, GA, GB = pba_mega.warp_slabs(
        model, problem.cam_states, problem.inv_depth, consts)
    aff = pba_mega.affine_slab(problem.cam_states.affine, consts)
    # push some observations off the image and make one non-finite
    Og = ux.shape[1]
    cols = torch.arange(0, Og, 97, device=device)
    ux[:, cols[0::3]] -= 0.8 * W
    uy[:, cols[1::3]] += 0.7 * H
    ux[:, cols[2::3]] += 1.3 * W
    ux[:, 5] = -1e6
    uy[:, 5] = -1e6
    args = (solve.images, ux, uy, GA, GB, consts.refp, aff, consts.iog,
            consts.cnt, HUBER)
    n_valid = int(consts.cnt.sum())
    print(f"phase 1: kernel vs plain at {K} images of {H}x{W}, "
          f"{n_valid} observations in {Og} rows")
    out = pba_mega.mega_rj(*args)
    ref = pba_mega.mega_rj_reference(*args)
    torch.cuda.synchronize()
    max_err = compare_payloads(out, ref, solve.images, "EuRoC scale")

    ms, plain_ms = timed_pair(lambda: pba_mega.mega_rj(*args),
                              lambda: pba_mega.mega_rj_reference(*args))
    wrapper_ms = time_ms(lambda: pba_mega.mega_rj(*args), device)
    print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per build on the "
          f"device (CUDA graphs of 20 calls, plain/kernel/kernel/plain); "
          f"through the wrapper {wrapper_ms:.4f} ms per call (20 calls "
          f"between CUDA events: the host's launch rate)")
    bound_ms = mega_bound_ms(args)
    print(f"  bound {bound_ms:.4f} ms: the kernel at "
          f"{bound_ms / ms:.1%} of it")

    # an image wider than the TPU kernel's 14-bit column field
    Hw, Ww, Ogw = 24, 8448, 2 * pba_mega.GROUP
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    imgs = (255 * torch.rand((2, Hw, Ww), generator=gen)).to(device)
    uxw = (8000 + 460 * torch.rand((8, Ogw), generator=gen)).to(device)
    uyw = (2 + 20 * torch.rand((8, Ogw), generator=gen)).to(device)
    GAw = torch.randn((104, Ogw), generator=gen).to(device)
    GBw = torch.randn((104, Ogw), generator=gen).to(device)
    refw = (255 * torch.rand((8, Ogw), generator=gen)).to(device)
    affw = (0.1 * torch.randn((4, Ogw), generator=gen)).to(device)
    iogw = torch.tensor([0, 1], dtype=torch.int32, device=device)
    cntw = torch.tensor([256, 200], dtype=torch.int32, device=device)
    argw = (imgs, uxw, uyw, GAw, GBw, refw, affw, iogw, cntw, HUBER)
    outw = pba_mega.mega_rj(*argw)
    refw_ = pba_mega.mega_rj_reference(*argw)
    torch.cuda.synchronize()
    compare_payloads(outw, refw_, imgs, f"W={Ww}")
    pad = (torch.arange(Ogw, device=device) % pba_mega.GROUP) >= \
        cntw.long().repeat_interleave(pba_mega.GROUP)
    check(bool((outw[:, pad] == 0).all()), "padding rows are not zero")
    return max_err, ms, plain_ms, bound_ms


def slice_phase(pipe, device, se3):
    """Phase 2: the photometric path.  Returns the kernel launch count."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    err0 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    n_obs = sum(len(lm.obs) - 1 for lm in pipe.landmarks.values())
    print(f"phase 2: refine_photometric, {len(pipe.cameras)} images, "
          f"{len(pipe.landmarks)} landmarks, {n_obs} observations, "
          f"{LEVELS} levels x {MAX_ITERATIONS} iterations")
    reset_counts()
    t0 = time.perf_counter()
    res = pba_refine.refine_photometric(
        pipe, levels=LEVELS, max_iterations=MAX_ITERATIONS,
        huber_delta=HUBER, log=lambda s: None, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pba_mega.KERNEL_LAUNCHES
    for lv in pipe.photometric_levels:
        print(f"  level {lv['level']} ({lv['W']}x{lv['H']}): cost "
              f"{lv['initial_cost']:.6e} -> {lv['cost']:.6e}, "
              f"{lv['iterations']} iterations, {lv['tries']} tries, set-up "
              f"{lv['setup_s']:.3f} s, solve {lv['solve_s']:.3f} s, "
              f"{lv['iterations'] / lv['solve_s']:.2f} LM it/s, "
              f"{lv['tries'] / lv['solve_s']:.2f} tries/s")
        check(math.isfinite(lv["cost"]), f"level {lv['level']}: non-finite cost")
        check(lv["cost"] < lv["initial_cost"],
              f"level {lv['level']}: cost did not fall")
    err1 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    print(f"  total {wall:.2f} s; kernel launches {launches}; pose error "
          f"vs ground truth: translation {err0[0]:.5f} -> {err1[0]:.5f} m, "
          f"rotation {err0[1]:.6f} -> {err1[1]:.6f} rad")
    check(math.isfinite(float(res.cost)), "final cost is not finite")
    check(all(np.isfinite(p).all() for p in pipe.cameras.values()),
          "non-finite pose")
    check(all(math.isfinite(lm.inv_depth) for lm in pipe.landmarks.values()),
          "non-finite inverse depth")
    check(err1[0] < err0[0] and err1[1] < err0[1],
          "pose error against ground truth did not shrink")
    expected = sum(lv["tries"] + 1 for lv in pipe.photometric_levels)
    check(launches == expected,
          f"kernel launches {launches} != builds {expected}")
    return launches


def sample_bound_ms(images, ux, uy, iog, cnt) -> float:
    """Least time of one sampler call on these inputs: the bytes it must
    move (ux and uy of each valid observation, each image pixel its taps
    touch and the group tables read once, 3 x 8 f32 per row written once)
    over the card's memory rate.  Its f32 operations (about 20 per point)
    take far less, so it is bytes-bound."""
    from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps

    K, H, W = images.shape
    Opad = ux.shape[1]
    G = ps.GROUP
    lane = torch.arange(Opad, device=ux.device) % G
    ok = lane < cnt.long().repeat_interleave(G)
    n_obs = int(ok.sum())
    img = iog.long().repeat_interleave(G)[ok]
    xs, ys = ux[:, ok], uy[:, ok]
    x0 = torch.floor(xs.clamp(0, W - 1.001)).long()
    y0 = torch.floor(ys.clamp(0, H - 1.001)).long()
    taps = torch.cat([((img * H + y0 + dy) * W + x0 + dx).reshape(-1)
                      for dy in (0, 1) for dx in (0, 1)])
    n_pix = int(torch.unique(taps).numel())
    nbytes = 4 * (2 * ps.P * n_obs + n_pix + 2 * iog.numel()) \
        + 4 * 3 * ps.P * Opad
    ops = 20 * ps.P * n_obs
    check(ops / H100_F32_OPS_PER_S < nbytes / H100_BYTES_PER_S,
          "sampler bound is not bytes")
    print(f"  bound: {nbytes / 1e6:.2f} MB ({n_obs} observations x "
          f"{8 * ps.P} B, {n_pix} image pixels, output "
          f"{12 * ps.P * Opad / 1e6:.2f} MB) at 3.35 TB/s")
    return 1e3 * nbytes / H100_BYTES_PER_S


def grid_sample_values(images, ux, uy, iog):
    """The value (not the gradient) of the sampler through one
    ``torch.nn.functional.grid_sample`` call: the stack as one tall image,
    coordinates clamped to their image and stacked, ``align_corners=True``
    and border padding.  Returns (call, values); ``call`` times the one
    library call alone.  A yardstick; the port never calls it."""
    from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps

    K, H, W = images.shape
    img = iog.long().repeat_interleave(ps.GROUP)[None, :]
    x = ux.clamp(0, W - 1.001)
    y = img * H + uy.clamp(0, H - 1.001)
    grid = torch.stack([2 * x / (W - 1) - 1, 2 * y / (K * H - 1) - 1],
                       dim=-1)[None]
    tall = images.reshape(1, 1, K * H, W)

    def call():
        return torch.nn.functional.grid_sample(
            tall, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    return call, call()[0, 0]


def check_first_build(solve, solve_ref, problem, plan, cfg, label: str):
    """The kernel solver's build against the gather solver's on the card,
    at the ROADMAP's parity tolerances."""
    cost, neq = solve.build(problem, plan, cfg)
    ref_cost, ref_neq = solve_ref.build(problem, plan, cfg)
    rel = abs(float(cost) - float(ref_cost)) / abs(float(ref_cost))
    check(rel <= NEQ_TOL[0], f"{label}: first build cost rel err {rel}")
    worst = []
    for name, a, b in zip(NEQ_NAMES, neq, ref_neq):
        scale = max(float(b.abs().max()), 1e-30)
        bound = NEQ_TOL[1] * scale + NEQ_TOL[2] * b.abs()
        ratio = float(((a - b).abs() / bound).max())
        check(ratio <= 1.0, f"{label}: {name} beyond the parity tolerance "
              f"({ratio:.3f} of bound)")
        worst.append(f"{name} {ratio:.1e}")
    print(f"  {label}: first build = the gather solver's on the card (cost "
          f"rel {rel:.2e}; pieces at this share of their bound: "
          f"{', '.join(worst)})")


def run_solver(solve, problem, plan, cfg, label: str):
    """One counted solve: returns (problem, result, launches, seconds)."""
    from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p, res = solve(problem, plan, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ps.KERNEL_LAUNCHES
    init, cost = float(res.initial_cost), float(res.cost)
    print(f"  {label}: cost {init:.6e} -> {cost:.6e}, {res.iterations} "
          f"iterations, {res.tries} tries, {res.builds} builds, "
          f"{res.residual_passes} residual passes in {secs:.3f} s: "
          f"{res.iterations / secs:.2f} LM it/s, {res.tries / secs:.2f} "
          f"tries/s; sampler launches {launches}")
    check(math.isfinite(cost), f"{label}: non-finite cost")
    check(cost < init, f"{label}: cost did not fall")
    check(bool(torch.isfinite(p.cam_states.pose).all()
               and torch.isfinite(p.inv_depth).all()),
          f"{label}: non-finite state")
    check(launches == res.builds + res.residual_passes,
          f"{label}: sampler launches {launches} != builds {res.builds} + "
          f"residual passes {res.residual_passes}")
    return p, res, launches, secs


def sampler_phase(pipe, device, se3):
    """Phase 4: the patch sampler at EuRoC scale and the two
    kernel-sampled fused solvers.  Returns the sampler's JSON fields."""
    from photometric_bundle_adjustment_tpu_torch.models import (
        photometric_ba as pba,
    )
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps
    from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        SEED,
        graph_ms,
        time_ms,
    )

    problem, images_flat, H, W, cam_list, _ = \
        pba_refine.build_photometric_problem(pipe, device=device)
    K = problem.cam_states.pose.shape[0]
    model = pipe.calib.cam_types[0]
    p_img, iog, cnt = pba.imagesort_problem(problem, K)
    solve_k = pba.make_kernel_fused_solver(model, images_flat, H, W, iog,
                                           cnt, device=device)
    images, rj_fn = solve_k.images, solve_k.fns[1]

    # (a) the kernel against its plain version on the warped coordinates
    o = p_img.obs
    Og = len(iog) * ps.GROUP
    ux, uy, _ = rj_fn.warp(ba.take_rows(p_img.cam_states, o.anchor_cam),
                           ba.take_rows(p_img.cam_states, o.target_cam),
                           p_img.inv_depth[o.landmark], o.aux)
    fin = torch.isfinite(ux) & torch.isfinite(uy)
    ux = torch.where(fin, ux, torch.full_like(ux, -1e6)).contiguous()
    uy = torch.where(fin, uy, torch.full_like(uy, -1e6)).contiguous()
    cols = torch.arange(0, Og, 97, device=device)
    ux[:, cols[0::3]] -= 0.8 * W
    uy[:, cols[1::3]] += 0.7 * H
    ux[:, cols[2::3]] += 1.3 * W
    ux[:, 5] = -1e6
    uy[:, 5] = -1e6
    iog_t, cnt_t = (torch.as_tensor(x, device=device) for x in (iog, cnt))
    args = (images, ux, uy, iog_t, cnt_t, (H, W), True)
    print(f"phase 4: patch sampler vs plain at {K} images of {H}x{W}, "
          f"{int(cnt.sum())} observations in {Og} rows ({len(iog)} groups)")
    out = ps.sample_patches_grouped(*args)
    ref = ps.sample_patches_reference(*args)
    torch.cuda.synchronize()
    scale = float(images.abs().max())
    max_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    check(max_err <= SAMPLE_ATOL * scale,
          f"sampler max err {max_err} > {SAMPLE_ATOL} * {scale}")
    pad = (torch.arange(Og, device=device) % ps.GROUP) >= \
        cnt_t.long().repeat_interleave(ps.GROUP)
    check(all(bool((a[:, pad] == 0).all()) for a in out),
          "sampler padding slots are not zero")
    print(f"  max|err| {max_err:.3e} (bound {SAMPLE_ATOL * scale:.3e}); "
          f"{int(pad.sum())} padding slots exactly zero")
    ms, plain_ms = timed_pair(lambda: ps.sample_patches_grouped(*args),
                              lambda: ps.sample_patches_reference(*args))
    wrapper_ms = time_ms(lambda: ps.sample_patches_grouped(*args), device)
    call, lib_val = grid_sample_values(images, ux, uy, iog_t)
    lib_err = float((lib_val - out[0])[:, ~pad].abs().max())
    check(lib_err <= 1e-2 * scale, f"grid_sample differs by {lib_err}")
    library_ms = graph_ms(call)
    print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call on the "
          f"device (CUDA graphs of 20 calls, plain/kernel/kernel/plain); one "
          f"grid_sample call {library_ms:.4f} ms (a graph of 20) for the "
          f"value alone, no gradient (within {lib_err:.2e} of the kernel's "
          f"value); through the wrapper {wrapper_ms:.4f} ms per call (20 "
          f"calls between CUDA events: the host's launch rate)")
    bound_ms = sample_bound_ms(images, ux, uy, iog_t, cnt_t)
    print(f"  bound {bound_ms:.4f} ms: the kernel at {bound_ms / ms:.1%} "
          f"of it")

    # (b) make_kernel_fused_solver on the map, classic loop
    cfg = ba.BAConfig(max_iterations=MAX_ITERATIONS, huber_delta=HUBER)
    plan = fused.plan_for_problem(p_img, pow2_buckets=False)
    solve_g = pba.make_fused_solver(model, images_flat, H, W, device=device)
    check_first_build(solve_k, solve_g, p_img, plan, cfg, "kernel_fused")
    err0 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    p, _, launches_b, _ = run_solver(solve_k, p_img, plan, cfg,
                                     f"kernel_fused ({K} images of {H}x{W}, "
                                     f"{Og} rows, classic loop)")
    poses = p.cam_states.pose.double().cpu().numpy()
    err1 = pose_errors(dict(zip(cam_list, poses)), pipe.poses_gt, se3)
    print(f"  kernel_fused pose error vs ground truth: translation "
          f"{err0[0]:.5f} -> {err1[0]:.5f} m, rotation {err0[1]:.6f} -> "
          f"{err1[1]:.6f} rad")
    check(err1[0] < err0[0] and err1[1] < err0[1],
          "kernel_fused: pose error against ground truth did not shrink")

    # (c) make_kernel_dense_solver on the uniform EuRoC-scale problem
    t0 = time.perf_counter()
    prob_u, imgs_u, Hu, Wu = synthetic.euroc_scale_pba(seed=SEED,
                                                       device=device)
    prob_d, plan_d = fused.densify_problem(prob_u, pow2_buckets=False)
    Ku = prob_u.cam_states.pose.shape[0]
    solve_d = pba.make_kernel_dense_solver("pinhole", imgs_u, Hu, Wu, prob_d,
                                           Ku, device=device)
    S = plan_d.lm_cam.shape[0]
    print(f"  euroc_scale_pba: {Ku} images of {Hu}x{Wu}, "
          f"{int((prob_u.obs.valid != 0).sum())} observations in {S} x "
          f"{prob_u.inv_depth.shape[0]} slots (set up in "
          f"{time.perf_counter() - t0:.1f} s)")
    cfg_d = cfg._replace(cost_from_build=True)
    solve_gd = pba.make_fused_solver("pinhole", imgs_u, Hu, Wu, device=device)
    check_first_build(solve_d, solve_gd, prob_d, plan_d, cfg_d,
                      "kernel_dense")
    _, _, launches_c, _ = run_solver(solve_d, prob_d, plan_d, cfg_d,
                                     "kernel_dense (fused-cost loop)")
    return dict(launches=launches_b + launches_c, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=library_ms)


def dense_phase(pipe, device, se3):
    """Phase 5: the dense slot-major family and the bf16 tier.  Returns
    the bf16 entry's JSON fields."""
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        SEED,
        graph_ms,
    )

    t0 = time.perf_counter()
    prob_u, imgs_u, H, W = synthetic.euroc_scale_pba(seed=SEED, device=device)
    prob_d, plan_d = fused.densify_problem(prob_u, pow2_buckets=False)
    K = prob_u.cam_states.pose.shape[0]
    torch.cuda.synchronize()
    base_mib = torch.cuda.memory_allocated(device) / 2**20
    solve_d = pba_mega.make_mega_solver("pinhole", imgs_u, H, W, prob_d, K,
                                        plan_d, device=device)
    solve_c = pba_mega.make_mega_solver("pinhole", imgs_u, H, W, prob_u, K,
                                        device=device)
    S = plan_d.lm_cam.shape[0]
    n_obs = int((prob_u.obs.valid != 0).sum())
    print(f"phase 5: dense family on euroc_scale_pba, {K} images of {H}x{W}, "
          f"{n_obs} observations in {S} x {prob_u.inv_depth.shape[0]} slot "
          f"rows, {solve_d.consts.iog.numel()} groups (set up in "
          f"{time.perf_counter() - t0:.1f} s)")

    # (a) the dense family's first build and damped solve = the chunk's
    cfg = ba.BAConfig(max_iterations=MAX_ITERATIONS, huber_delta=HUBER,
                      cost_from_build=True)
    c_d, neq_d = solve_d.build(prob_d, cfg)
    c_c, neq_c = solve_c.build(prob_u, cfg)
    rel = abs(float(c_d) - float(c_c)) / abs(float(c_c))
    check(rel <= 1e-5, f"dense build cost rel err {rel} against the chunk's")
    free = ~prob_u.fixed_cams
    deltas_d = solve_d.solve_lam(neq_d, 1e-4, free, cfg)
    deltas_c = solve_c.solve_lam(neq_c, 1e-4, free, cfg)
    errs = []
    for name, a, b in zip(("delta_c", "delta_p"), deltas_d, deltas_c):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        check(err <= 2e-3, f"dense {name} differs from the chunk family's "
              f"by {err:.3e} x max")
        errs.append(f"{name} {err:.2e}")
    print(f"  (a) first build = the chunk family's (cost rel {rel:.2e}); "
          f"damped solve at lambda 1e-4: max|err| / max|ref| "
          f"{', '.join(errs)}")
    del neq_d, neq_c, solve_c

    # (b) the bf16 kernel against its plain version on the widened stack
    cfg16 = cfg._replace(sample_bf16=True)
    consts = solve_d.consts
    ux, uy, _, GA, GB = pba_mega.warp_slabs(
        "pinhole", prob_d.cam_states, prob_d.inv_depth, consts)
    aff = pba_mega.affine_slab(prob_d.cam_states.affine, consts)
    rest = (ux, uy, GA, GB, consts.refp, aff, consts.iog, consts.cnt, HUBER)
    bf = solve_d.stack(cfg16)
    stack_mib = bf.numel() * bf.element_size() / 2**20
    args16 = (bf,) + rest
    out = pba_mega.mega_rj(*args16)
    ref = pba_mega.mega_rj_reference(*args16)
    torch.cuda.synchronize()
    max_err = compare_payloads(out, ref, bf.float(), "(b) bf16 kernel")
    del out, ref
    ms, plain_ms = timed_pair(lambda: pba_mega.mega_rj(*args16),
                              lambda: pba_mega.mega_rj_reference(*args16))
    ms32 = graph_ms(lambda: pba_mega.mega_rj(solve_d.images, *rest))
    print(f"  bf16 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the f32 "
          f"kernel on the same inputs {ms32:.4f} ms per build on the device "
          f"(CUDA graphs of 20 calls)")
    bound_ms = mega_bound_ms(args16)
    print(f"  bound {bound_ms:.4f} ms: the bf16 kernel at "
          f"{bound_ms / ms:.1%} of it")

    # (c) the dense solver in both tiers, the fused-cost loop
    launches = 0
    for tier, c in (("f32", cfg), ("bf16", cfg16)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held_mib = torch.cuda.memory_allocated(device) / 2**20
        reset_counts()
        t0 = time.perf_counter()
        p, res = solve_d(prob_d, c)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n32, n16 = pba_mega.KERNEL_LAUNCHES, pba_mega.KERNEL_LAUNCHES_BF16
        init, cost = float(res.initial_cost), float(res.cost)
        print(f"  (c) dense solver, {tier}: cost {init:.6e} -> {cost:.6e}, "
              f"{res.iterations} iterations, {res.tries} tries in {secs:.3f} "
              f"s: {res.iterations / secs:.2f} LM it/s, "
              f"{res.tries / secs:.2f} tries/s; launches f32 {n32}, bf16 "
              f"{n16}; peak {torch.cuda.max_memory_allocated(device) / 2**20:.1f}"
              f" MiB, {held_mib:.1f} held before the solve ({base_mib:.1f} "
              f"before the solvers were made, the bf16 stack {stack_mib:.1f})")
        check(math.isfinite(cost) and cost < init,
              f"dense {tier}: cost did not fall to a finite value")
        check(bool(torch.isfinite(p.cam_states.pose).all()
                   and torch.isfinite(p.inv_depth).all()),
              f"dense {tier}: non-finite state")
        want = (res.tries + 1, 0) if tier == "f32" else (0, res.tries + 1)
        check((n32, n16) == want, f"dense {tier}: launches (f32, bf16) "
              f"{(n32, n16)} != builds {want}")
        launches += n16
    del solve_d, args16, rest, bf

    # (d) refine_photometric in the bf16 tier on the initial map
    err0 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    reset_counts()
    t0 = time.perf_counter()
    pba_refine.refine_photometric(
        pipe, levels=LEVELS, max_iterations=MAX_ITERATIONS,
        huber_delta=HUBER, sample_bf16=True, log=lambda s: None,
        device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n32, n16 = pba_mega.KERNEL_LAUNCHES, pba_mega.KERNEL_LAUNCHES_BF16
    for lv in pipe.photometric_levels:
        print(f"  (d) bf16 level {lv['level']} ({lv['W']}x{lv['H']}): cost "
              f"{lv['initial_cost']:.6e} -> {lv['cost']:.6e}, "
              f"{lv['iterations']} iterations, {lv['tries']} tries, "
              f"{lv['iterations'] / lv['solve_s']:.2f} LM it/s")
        check(math.isfinite(lv["cost"]) and lv["cost"] < lv["initial_cost"],
              f"bf16 level {lv['level']}: cost did not fall")
    err1 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    builds = sum(lv["tries"] + 1 for lv in pipe.photometric_levels)
    print(f"  (d) total {wall:.2f} s; launches f32 {n32}, bf16 {n16}; pose "
          f"error: translation {err0[0]:.5f} -> {err1[0]:.5f} m, rotation "
          f"{err0[1]:.6f} -> {err1[1]:.6f} rad")
    check((n32, n16) == (0, builds),
          f"refine bf16: launches (f32, bf16) {(n32, n16)} != (0, {builds})")
    check(err1[0] < err0[0] and err1[1] < err0[1],
          "refine bf16: pose error against ground truth did not shrink")
    return dict(launches=launches + n16, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None)


def probe_phase(device):
    """Phase 6: the grid-overhead probe and the window read.  Returns the
    JSON fields of both."""
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        H100_BYTES_PER_S,
        graph_ms,
    )
    from photometric_bundle_adjustment_tpu_torch.scripts import (
        exp_roll,
        grid_overhead as go,
    )

    print("phase 6: the grid-overhead probe (11 variants: device ms, plain "
          "ms, bound)")
    reset_counts()
    rows = go.run(device, log=lambda line: print("  " + line))
    go_launches = go.KERNEL_LAUNCHES
    base = rows[0]["ms"]
    for r in rows:
        extra = "" if r is rows[0] else f", {r['ms'] - base:+.4f} ms"
        print(f"  {r['ms']:.4f} ms{extra} beside the output-only variant: "
              f"{r['label']}")
    scratch = next(r for r in rows if "scratch_bytes" in r)
    print(f"  the scratch variant reserves {scratch['scratch_bytes']} B of "
          f"dynamic shared memory per block")
    ng_cols = go.NG * go.GROUP
    library_ms = graph_ms(lambda: torch.zeros((go.OUT_ROWS, ng_cols),
                                              device=device))
    print(f"  one torch.zeros of the output: {library_ms:.4f} ms")
    entry = next(r for r in rows
                 if r["label"] == f"3 prefetch ({ng_cols} code), no scratch")
    grid = dict(launches=go_launches, max_abs_err=entry["max_abs_err"],
                ms=entry["ms"], plain_ms=entry["plain_ms"],
                bound_ms=entry["bound_ms"], bound_by="bytes",
                library_ms=library_ms)

    print("  window read: the script's call, B = 1")
    reset_counts()
    ok = exp_roll.main(["--device", str(device)])
    roll_launches = exp_roll.KERNEL_LAUNCHES
    check(all(ok.values()), f"exp_roll entry point: {ok}")
    gen = torch.Generator(device="cpu").manual_seed(0)
    fields = None
    for B in (1, 4096):
        x = torch.randn((B, exp_roll.ROWS, exp_roll.COLS),
                        generator=gen).to(device)
        s = torch.full((B,), exp_roll.SHIFT, dtype=torch.int32, device=device)
        for mode in exp_roll.MODES:
            out = exp_roll.window(x, s, mode)
            ref = exp_roll.window_reference(x, s, mode)
            check(torch.equal(out, ref),
                  f"exp_roll {mode} at B={B} differs from its plain version")
            err = float((out - ref).abs().max())
            ms, plain_ms = timed_pair(
                lambda: exp_roll.window(x, s, mode),
                lambda: exp_roll.window_reference(x, s, mode))
            # the function needs only the 128 columns of its window: each
            # of them read once, each output written once, the shifts read
            nbytes = 4 * (2 * out.numel() + s.numel())
            bound_ms = 1e3 * nbytes / H100_BYTES_PER_S
            line = (f"  {mode} at B={B}: bit-identical; {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ("
                    f"{nbytes / 1e6:.2f} MB)")
            if mode == "roll":
                shift = -exp_roll.SHIFT
                check(torch.equal(torch.roll(x, shift, 2)[..., :exp_roll.WIN],
                                  out), "torch.roll differs from the kernel")
                library_ms = graph_ms(lambda: torch.roll(x, shift, 2))
                line += f"; one torch.roll {library_ms:.4f} ms"
                if B == 4096:
                    fields = dict(launches=roll_launches, max_abs_err=err,
                                  ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by="bytes",
                                  library_ms=library_ms)
            print(line + f": the kernel at {bound_ms / ms:.1%} of the bound")
    return grid, fields


def hamming_resources():
    """Phase 0's account of the Hamming kernel, read from the built library
    with ``cuobjdump``: each instance's registers, stack and local memory
    (``-res-usage``; spills would show as local memory) and its
    tensor-core instructions (``-sass``: IMMA, BMMA or HGMMA), then its
    dynamic shared memory at the front end's F = 512.  Fails unless every
    instance issues tensor-core instructions and none spills."""
    import re

    from photometric_bundle_adjustment_tpu_torch.ops import _build, hamming

    cuobjdump = _build._nvcc().rsplit("/", 1)[0] + "/cuobjdump"

    def dump(flag):
        return subprocess.run([cuobjdump, flag, _build.load("hamming")._name],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout

    def per_function(text, pattern):
        out, fn = {}, None
        for line in text.splitlines():
            m = re.search(r"Function\s*:?\s*(\w+)", line)
            if m:
                fn = m.group(1)
                out.setdefault(fn, [])
            elif fn:
                out[fn] += re.findall(pattern, line)
        return out

    res = per_function(dump("-res-usage"), r"(REG|STACK|LOCAL):(\d+)")
    mma = per_function(dump("-sass"), r"\b(IMMA|BMMA|HGMMA)\b")
    for fn in sorted(mma):
        # hamming_kernel<kBoth>
        tag = re.search(r"hamming_kernelILb(\d)E", fn)
        if not tag:
            continue
        both = tag.group(1) == "1"
        usage = dict((k, int(v)) for k, v in res.get(fn, []))
        ops = {op: mma[fn].count(op) for op in sorted(set(mma[fn]))}
        print(f"  hamming, {'both directions' if both else 'forward'}: "
              f"{usage.get('REG', 'not read')} registers, stack "
              f"{usage.get('STACK', 'not read')} B, local "
              f"{usage.get('LOCAL', 'not read')} B; tensor-core SASS "
              f"{', '.join(f'{k} x{v}' for k, v in ops.items()) or 'none'}")
        check(usage.get("STACK", 0) == 0 and usage.get("LOCAL", 0) == 0,
              f"{fn} spills registers")
        check(sum(ops.values()) > 0, f"{fn} issues no tensor-core "
              f"instruction")
    print(f"  hamming: {hamming.smem_bytes(512, 512, True)} B of shared "
          f"memory a block at F = 512, both directions "
          f"({hamming.smem_bytes(512, 512, False)} B forward)")


def mma_rates(device) -> dict:
    """The card's sustained mma.sync rate, in operations per second, of
    the b1 AND+POPC form (the Hamming kernel's product) and the s8 form:
    ``csrc/mma_rate.cu`` at 4 blocks of 8 warps per SM, the best of 3
    launches of each timed with CUDA events after one warm-up."""
    import ctypes

    from photometric_bundle_adjustment_tpu_torch.ops import _build

    fn = _build.load("mma_rate").mma_rate
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    sink = torch.empty(blocks * 256, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    ops = ctypes.c_longlong()
    rates = {}
    for form, (code, iters) in {"b1": (0, 2048), "s8": (1, 8192)}.items():
        def run():
            err = fn(code, blocks, iters, sink.data_ptr(), ctypes.byref(ops),
                     stream)
            check(err == 0, f"mma_rate {form} failed to launch ({err})")
        run()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        rates[form] = ops.value / (min(times) / 1e3)
        print(f"  mma.sync {form}: {rates[form] / 1e12:.1f} TOP/s sustained "
              f"({ops.value:.3e} operations in {min(times):.4f} ms, best of "
              f"3; the data sheet's dense int8 peak, for wgmma, is 1,979)")
    return rates


def int_mm_best_two(desc, valid):
    """The Hamming best-two of every ordered image pair through the int8
    tensor cores, as one PyTorch library call per image: descriptors as
    {0, 1} bit planes, H(a, b) = pop(a) + pop(b) - 2 a.b by
    ``torch._int_mm``, then the plain min reductions.  Returns best,
    second, idx, each (I, F, I): [a, row, b].  A yardstick for the
    kernel's time; the port never calls it."""
    from photometric_bundle_adjustment_tpu_torch.ops import hamming

    I, F, _ = desc.shape
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    planes = ((desc[..., None] >> shifts) & 1).reshape(I * F, 256)
    planes = planes.to(torch.int8)
    pop = planes.sum(1, dtype=torch.int32)
    big = torch.tensor(hamming.BIG, dtype=torch.int32, device=desc.device)
    col_ok = valid.reshape(1, -1)
    out = [torch.empty((I, F, I), dtype=torch.int32, device=desc.device)
           for _ in range(3)]
    for i in range(I):
        rows = slice(i * F, (i + 1) * F)
        ab = torch._int_mm(planes[rows], planes.t())
        dist = torch.where(col_ok, pop[rows, None] + pop[None, :] - 2 * ab, big)
        for o, r in zip(out, hamming.best_two_from(dist.reshape(F, I, F), 2)):
            o[i] = r
    return out


def hamming_bound_ms(valid, a, b, F, b1_rate) -> tuple[float, str]:
    """Least time of the all-pairs best-two (both directions) on these
    inputs: the larger of the bytes (descriptor stack, masks and pair
    indices read once, three (P, F) int32 outputs per direction written
    once) over the memory rate, and the operations of one 256-term product
    per pair between its valid descriptors (2 x 256 per distance; one
    product serves both directions) over the faster of the two routes:
    int8 bit planes at the data sheet's peak, or b1 words at ``b1_rate``,
    the sustained rate phase 0 measured."""
    n = valid.sum(1).double()
    P = a.numel()
    ops = float((n[a] * n[b]).sum()) * 256 * 2
    nbytes = valid.numel() * (32 + 1) + 2 * 2 * 4 * P + 2 * 3 * 4 * P * F
    t_int8, t_b1 = ops / H100_INT8_OPS_PER_S, ops / b1_rate
    t_ops, t_bytes = min(t_int8, t_b1), nbytes / H100_BYTES_PER_S
    print(f"  bound: {ops:.3e} operations ({1e3 * t_int8:.4f} ms as int8 at "
          f"1,979 TOP/s, {1e3 * t_b1:.4f} ms as b1 at the measured "
          f"{b1_rate / 1e12:.1f}), {nbytes / 1e6:.1f} MB ({1e3 * t_bytes:.4f} "
          f"ms at 3.35 TB/s)")
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def front_end_phase(device, b1_rate):
    """Phase 3: the SfM front end at EuRoC V1's size; ``b1_rate`` is phase
    0's measured b1 mma rate, for the Hamming bound.  Returns the Hamming
    kernel's JSON fields."""
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.features import (
        describe,
        match,
        pair_matching,
    )
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import hamming
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        SEED,
        time_ms,
    )

    t0 = time.perf_counter()
    seq = synthetic.synth_stereo_sequence(n_frames=FRONT_FRAMES, H=FRONT_H,
                                          W=FRONT_W, seed=SEED, device=device)
    n_img = len(seq.images)
    print(f"phase 3: SfM front end, {n_img} images of {FRONT_H}x{FRONT_W} "
          f"(rendered on the card in {time.perf_counter() - t0:.1f} s)")
    pipe = SfmPipeline(seq.images, seq.calib, log=lambda s: None,
                       device=device)
    cfg = pipe.cfg

    # the main path, counts from 0
    reset_counts()
    t0 = time.perf_counter()
    pipe.detect_keypoints()
    t1 = time.perf_counter()
    pipe.match_stereo()
    t2 = time.perf_counter()
    ids = np.array(pipe._pair_worklist())
    _, valid, desc, _ = pipe._stack_features()
    table = pair_matching.match_pairs(
        desc, valid, ids[:, 0], ids[:, 1], cfg.feature_match_max_dist,
        cfg.feature_match_test_next_best)
    compact = match.matches_to_pairs(table, cfg.max_matches_per_pair)
    count = compact[2].cpu().numpy()
    t3 = time.perf_counter()
    launches = hamming.KERNEL_LAUNCHES
    n_stereo = len(pipe.matches)

    n = np.array([int(pipe.corners[k]["valid"].sum()) for k in pipe.fcids])
    P, F = len(ids), desc.shape[1]
    print(f"  detect: {1e3 * (t1 - t0) / n_img:.2f} ms per image "
          f"({t1 - t0:.3f} s, {pipe.counters['detect_batches']} batches of "
          f"8); valid corners per image min {n.min()}, median "
          f"{int(np.median(n))}, max {n.max()}; compacted to F={F}")
    check(CORNERS_MEDIAN[0] <= np.median(n) <= CORNERS_MEDIAN[1],
          f"median corner count {np.median(n)} outside {CORNERS_MEDIAN}")
    n_m = sum(len(m["matches"]) for m in pipe.matches.values())
    n_i = sum(len(m["inliers"]) for m in pipe.matches.values())
    print(f"  match_stereo: {n_stereo} pairs in {t2 - t1:.3f} s, {n_m} "
          f"matches, {n_i} epipolar inliers")
    print(f"  match_pairs: {P} pairs at F={F} in {t3 - t2:.3f} s with the "
          f"compaction on the card ({P / (t3 - t2):.0f} pairs/s); "
          f"{int((table >= 0).sum())} mutual matches, {int(count.sum())} "
          f"kept at {cfg.max_matches_per_pair} per pair")
    for got, ref in zip(compact, pair_matching.compact_matches_np(
            table.cpu().numpy(), cfg.max_matches_per_pair)):
        check(np.array_equal(got.cpu().numpy(), ref),
              "matches_to_pairs differs from compact_matches_np")
    check(P == FRONT_FRAMES * (FRONT_FRAMES - 1) * 2,
          f"worklist has {P} pairs")
    print(f"  Hamming kernel launches on the path: {launches}")
    check(launches == 2, f"Hamming launches {launches} != 1 for "
          f"match_stereo + 1 for match_pairs")

    # stereo inliers against the rendered ground truth
    close = 0
    for ((f, _), _), m in pipe.matches.items():
        inl = m["inliers"]
        uv_r = pipe.corners[(f, 1)]["uv"][inl[:, 1]]
        uv_t, front = seq.correspondence(
            (f, 0), (f, 1), pipe.corners[(f, 0)]["uv"][inl[:, 0]])
        close += int(((np.linalg.norm(uv_t - uv_r, axis=1) <= GT_PX)
                      & front).sum())
    share = close / max(n_i, 1)
    print(f"  stereo inliers within {GT_PX} px of the true correspondence: "
          f"{close} of {n_i} ({share:.1%})")
    check(n_i > 0 and share >= GT_SHARE,
          f"only {share:.1%} of the stereo inliers on the ground truth")

    # detection and description on the card against the CPU plain path
    keys = pipe.fcids[:CHECK_IMAGES]
    imgs = torch.as_tensor(np.stack([seq.images[k] for k in keys]))
    ref = interop.features_to_numpy(dict(zip(
        ("uv", "valid", "angles", "desc"),
        describe.detect_and_describe_batch(imgs, cfg.num_features_per_image))))
    flips = bits = 0
    ang_err = 0.0
    for i, k in enumerate(keys):
        c = pipe.corners[k]
        check(np.array_equal(c["uv"], ref["uv"][i])
              and np.array_equal(c["valid"], ref["valid"][i]),
              f"corners of {k} differ from the CPU plain path")
        v = c["valid"]
        ang_err = max(ang_err, float(np.abs(c["angles"][v]
                                            - ref["angles"][i][v]).max()))
        x = c["desc"][v] ^ ref["desc"][i][v]
        flips += int(np.unpackbits(x.view(np.uint8)).sum())
        bits += x.size * 32
    print(f"  {len(keys)} images against the CPU plain path: corners "
          f"identical, angles within {ang_err:.2e} rad, {flips} of {bits} "
          f"descriptor bits differ")
    check(ang_err <= ANGLE_ATOL, f"angles differ by {ang_err}")
    check(flips <= BIT_FLIP_SHARE * bits, f"{flips} descriptor bits differ")

    # the kernel against its plain version over the whole worklist
    a = torch.as_tensor(ids[:, 0], device=device)
    b = torch.as_tensor(ids[:, 1], device=device)

    def kernel_both():
        return hamming.best_two_both(desc, valid, desc, valid, a, b)

    def plain_both():
        return hamming.best_two_both_reference(desc, valid, desc, valid, a, b)

    out, ref = kernel_both(), plain_both()
    torch.cuda.synchronize()
    max_err = max(int((o - r).abs().max()) for o, r in zip(out, ref))
    check(all(torch.equal(o, r) for o, r in zip(out, ref)),
          f"Hamming kernel differs from its plain version (max {max_err})")
    print(f"  kernel bit-identical to the plain version over all {P} pairs, "
          f"both directions")
    lib = int_mm_best_two(desc, valid)
    for (o_f, o_b), l in zip(zip(out[:3], out[3:]), lib):
        check(torch.equal(l[a, :, b], o_f) and torch.equal(l[b, :, a], o_b),
              "the _int_mm form differs from the kernel")
    del ref, lib

    plain_ms = [time_ms(plain_both, device, reps=1, warmup=0)]
    ms = [time_ms(kernel_both, device, reps=10, warmup=1)]
    library_ms = time_ms(lambda: int_mm_best_two(desc, valid), device,
                         reps=2, warmup=1)
    ms.append(time_ms(kernel_both, device, reps=10, warmup=0))
    plain_ms.append(time_ms(plain_both, device, reps=1, warmup=0))
    ms, plain_ms = float(np.mean(ms)), float(np.mean(plain_ms))
    print(f"  all-pairs best-two, both directions in one launch: kernel "
          f"{ms:.4f} ms ({P / ms * 1e3:.0f} pairs/s), plain {plain_ms:.4f} "
          f"ms, _int_mm form {library_ms:.4f} ms over all {n_img}^2 ordered "
          f"pairs (CUDA events; plain/kernel/library/kernel/plain)")
    bound_ms, bound_by = hamming_bound_ms(valid, a, b, F, b1_rate)
    print(f"  bound {bound_ms:.4f} ms ({bound_by}): the kernel at "
          f"{bound_ms / ms:.1%} of it")
    return dict(launches=launches, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from photometric_bundle_adjustment_tpu_torch.core import se3
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.ops import _build
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        EUROC,
        SEED,
    )

    device = torch.device("cuda", 0)
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load_all()
    build_s = time.perf_counter() - t0
    print(f"phase 0: built {', '.join(_build.SOURCES)} in {build_s:.2f} s")
    for name, (secs, log) in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}")
    hamming_resources()
    rates = mma_rates(device)

    t0 = time.perf_counter()
    pipe = synthetic.synth_pba_pipe(seed=SEED, **EUROC)
    pipe0 = copy.deepcopy(pipe)       # phases 4-5 start from the initial map
    pipe5 = copy.deepcopy(pipe)
    print(f"synthetic map in {time.perf_counter() - t0:.1f} s")
    max_err, ms, plain_ms, bound_ms = kernel_phase(pipe, device)
    launches = slice_phase(pipe, device, se3)
    front = front_end_phase(device, rates["b1"])
    sampler = sampler_phase(pipe0, device, se3)
    bf16 = dense_phase(pipe5, device, se3)
    grid, window = probe_phase(device)

    print(json.dumps({"kernels": [{
        "name": "pba_mega_rj",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/pba_mega.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/pba_mega.py:456",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "pba_mega_rj_bf16",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/pba_mega.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/pba_mega.py:456",
        **bf16,
    }, {
        "name": "hamming_best_two",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/hamming.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/hamming.py:34",
        **front,
    }, {
        "name": "patch_sample",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/patch_sample.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/patch_sample.py:61",
        **sampler,
    }, {
        "name": "grid_overhead",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/grid_overhead.cu",
        "replaces": "scripts/grid_overhead.py:48",
        **grid,
    }, {
        "name": "exp_roll",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/exp_roll.cu",
        "replaces": "scripts/exp_roll.py:32",
        **window,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
