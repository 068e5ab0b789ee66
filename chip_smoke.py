#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, sm_90a), nvcc, and this checkout; imports no
JAX.  Phases, each of which raises (exit code 1) on failure:

  0. print the card's name and power limit; build the CUDA kernels from
     ``photometric_bundle_adjustment_tpu_torch/csrc`` and time the build;
  1. the megakernel against its plain PyTorch version on the card, at
     EuRoC scale (164 images of 480x752, ~4.8k landmarks, ~30k
     observations, some warped off the image, one non-finite) and on a
     small image 8448 pixels wide; both timed with CUDA events;
  2. the main path: ``refine_photometric`` on a synthetic EuRoC-scale map
     (3 pyramid levels, 20 iterations, Huber 9), checking that the cost
     falls at every level, that the result is finite, that the pose error
     against ground truth shrank and that every kernel of the path ran;
  3. print one JSON line describing each kernel, the card line again, and
     as the last line ``{"ok": true, "device": {...}}``.

Without CUDA it exits with code 2 and prints no result.
"""

from __future__ import annotations

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


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def kernel_phase(pipe, device):
    """Phase 1: the kernel against the plain version at EuRoC scale and on
    an 8448-pixel-wide image.  Returns (max_abs_err, ms, plain_ms)."""
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

    plain_ms = [time_ms(lambda: pba_mega.mega_rj_reference(*args), device)]
    ms = [time_ms(lambda: pba_mega.mega_rj(*args), device)]
    ms.append(time_ms(lambda: pba_mega.mega_rj(*args), device))
    plain_ms.append(time_ms(lambda: pba_mega.mega_rj_reference(*args), device))
    ms, plain_ms = float(np.mean(ms)), float(np.mean(plain_ms))
    print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per build "
          f"(mean of 2 x 20 calls, plain/kernel/kernel/plain)")

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
    return max_err, ms, plain_ms


def slice_phase(pipe, device, se3):
    """Phase 2: the main path.  Returns the kernel launch count."""
    from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    err0 = pose_errors(pipe.cameras, pipe.poses_gt, se3)
    n_obs = sum(len(lm.obs) - 1 for lm in pipe.landmarks.values())
    print(f"phase 2: refine_photometric, {len(pipe.cameras)} images, "
          f"{len(pipe.landmarks)} landmarks, {n_obs} observations, "
          f"{LEVELS} levels x {MAX_ITERATIONS} iterations")
    pba_mega.KERNEL_LAUNCHES = 0
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
    _build.load("pba_mega")
    build_s = time.perf_counter() - t0
    print(f"phase 0: built pba_mega in {build_s:.2f} s")
    for name, (secs, log) in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    pipe = synthetic.synth_pba_pipe(seed=SEED, **EUROC)
    print(f"synthetic map in {time.perf_counter() - t0:.1f} s")
    max_err, ms, plain_ms = kernel_phase(pipe, device)
    launches = slice_phase(pipe, device, se3)

    print(json.dumps({"kernels": [{
        "name": "pba_mega_rj",
        "route": "cuda",
        "source": "photometric_bundle_adjustment_tpu_torch/csrc/pba_mega.cu",
        "replaces": "photometric_bundle_adjustment_tpu/ops/pba_mega.py:456",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
