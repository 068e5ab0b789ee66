"""Where the time of one LM try goes, at full resolution.

    python3 -m photometric_bundle_adjustment_tpu_torch.profile_solve \
        [--solver {mega,fused,kernel_fused,kernel_dense}]

``--solver mega`` (the default) builds the synthetic EuRoC-scale map
``EUROC`` (164 images of 480x752, about 4.8k landmarks, about 30k
observations, seed 0; ``chip_smoke.py`` drives the same map) and the
level-0 solver ``refine_photometric`` would build for it, warms up, and
then, at the map's initial state:

  * times each piece of a try, mean of ``--reps`` calls (CUDA events on a
    GPU, the host clock on the CPU): the whole build (``warp_slabs``, the
    megakernel and the chunk-plan assembly), ``warp_slabs`` alone, the
    megakernel alone and the damped solve ``solve_lam``;
  * runs ``--tries`` LM tries (damped solve, retraction, build at the trial
    point, host sync of the trial cost, as ``make_mega_solver``'s loop does)
    under ``torch.profiler`` and reports the wall time, the device busy time
    (union of the device kernels' intervals), the device kernels per try and
    the operators with the largest device self time;
  * reports the peak device memory of the set-up and the tries.

The other solvers run on ``synthetic.euroc_scale_pba`` (164 images of
480x752, 4.8k landmarks each seen by the next 5 images, 24k
observations, seed 0: the workload of the JAX package's
``scripts/profile_pba.py``), each with its chunk plans built without
power-of-two buckets:

  * ``fused``: ``make_fused_solver`` (gather sampling, chunk build);
  * ``kernel_fused``: ``make_kernel_fused_solver`` on the
    ``imagesort_problem`` order (patch kernel, chunk build), the
    counterpart of ``profile_pba.py:main_kernel``;
  * ``kernel_dense``: ``make_kernel_dense_solver`` on ``densify_problem``
    (patch kernel, slot-major dense build), the counterpart of
    ``scripts/profile_pba_dense.py``.

For them it times the build, its pieces (the warp with its Jacobian
terms, the sampler, the whole batched rj function; the assembly is the
build less rj) and ``solve_lam``, then profiles ``--tries`` accepted
iterations of the classic LM loop (build, damped solve, retraction,
residual pass, host sync of the cost) the same way.

Prints one JSON object with every number as its last line.  ``--device
cpu`` with small ``--K/--L/--H/--W`` runs the same code on the plain path.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.models.photometric_ba import (
    cam_retract,
)
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine


# The EuRoC-scale synthetic map: V1's image count, size and camera model,
# about 4.8k landmarks and 30k observations with a heavy tail of tracks.
EUROC = dict(K=164, L=4800, H=480, W=752, obs_per_lm=5, long_tracks=200)
SEED = 0


def time_ms(fn, device: torch.device, reps: int = 20,
            warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` after ``warmup`` calls: CUDA
    events on a GPU, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_run(fn, runs: int, device: torch.device, top: int = 8) -> dict:
    """``runs`` calls of ``fn`` under ``torch.profiler`` (``fn`` ends in a
    host sync): the wall time, the device busy time (union of the device
    kernels' intervals) and its share of the wall, the device kernels per
    call and the operators with the largest self time on the device (on
    the host off the card)."""
    from torch.profiler import ProfilerActivity, profile

    gpu = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if gpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    key = "self_device_time_total" if gpu else "self_cpu_time_total"
    ops = sorted(prof.key_averages(), key=lambda e: getattr(e, key),
                 reverse=True)[:top]
    return dict(
        wall_ms=wall_ms,
        device_busy_ms=busy_ms if gpu else None,
        device_busy_share=busy_ms / wall_ms if gpu else None,
        device_kernels_per_run=len(kernels) / runs if gpu else None,
        top_self_ms={e.key: [e.count, getattr(e, key) / 1e3] for e in ops},
        top_by=key,
    )


def profile_tries(solve, problem, cfg: ba.BAConfig, tries: int,
                  device: torch.device, top: int = 8) -> dict:
    """``tries`` LM tries at ``problem`` under ``torch.profiler``."""
    free = ~problem.fixed_cams
    lam = float(cfg.init_lambda)
    _, neq = solve.build(problem, cfg)

    def one_try():
        dc, dp = solve.solve_lam(neq, lam, free, cfg)
        p_try = problem._replace(
            cam_states=cam_retract(problem.cam_states, dc),
            inv_depth=problem.inv_depth + dp)
        cost_try, _ = solve.build(p_try, cfg)
        return float(cost_try)                 # the loop's one host sync

    one_try()
    res = profile_run(one_try, tries, device, top)
    res["device_kernels_per_try"] = res.pop("device_kernels_per_run")
    return dict(tries=tries, **res)


FUSED_SOLVERS = ("fused", "kernel_fused", "kernel_dense")


def fused_case(solver: str, problem: ba.BAProblem, images_flat, H: int,
               W: int, device: torch.device):
    """``(solve, problem2, plan)``: the solver of ``--solver`` on the
    problem in the order and with the plan it takes (chunk plans without
    power-of-two buckets)."""
    K = problem.cam_states.pose.shape[0]
    if solver == "fused":
        return (pba.make_fused_solver("pinhole", images_flat, H, W,
                                      device=device), problem,
                fused.plan_for_problem(problem, pow2_buckets=False))
    if solver == "kernel_fused":
        p2, iog, cnt = pba.imagesort_problem(problem, K)
        return (pba.make_kernel_fused_solver("pinhole", images_flat, H, W,
                                             iog, cnt, device=device), p2,
                fused.plan_for_problem(p2, pow2_buckets=False))
    p2, plan = fused.densify_problem(problem, pow2_buckets=False)
    return (pba.make_kernel_dense_solver("pinhole", images_flat, H, W, p2, K,
                                         device=device), p2, plan)


def profile_fused(args, device: torch.device) -> dict:
    """Phase times and the profiled iterations of one fused solver."""
    gpu = device.type == "cuda"
    if gpu:
        torch.cuda.reset_peak_memory_stats(device)
    problem, images_flat, H, W = synthetic.euroc_scale_pba(
        K=args.K, L=args.L, obs_per_lm=args.obs_per_lm, H=args.H, W=args.W,
        seed=SEED, device=device)
    solve, problem, plan = fused_case(args.solver, problem, images_flat, H,
                                      W, device)
    cfg = ba.BAConfig(huber_delta=9.0)
    res_fn, rj_fn = solve.fns
    res_cost = ba.make_residual_cost(res_fn)
    o = problem.obs
    gathered = (ba.take_rows(problem.cam_states, o.anchor_cam),
                ba.take_rows(problem.cam_states, o.target_cam),
                problem.inv_depth[o.landmark], o.aux)
    ux, uy, _ = rj_fn.warp(*gathered)
    fin = torch.isfinite(ux) & torch.isfinite(uy)
    ux = torch.where(fin, ux, torch.full_like(ux, -1e6))
    uy = torch.where(fin, uy, torch.full_like(uy, -1e6))
    free = ~problem.fixed_cams
    _, neq = solve.build(problem, plan, cfg)

    def ms(fn):
        return time_ms(fn, device, args.reps)

    phases = dict(
        build_ms=ms(lambda: solve.build(problem, plan, cfg)),
        warp_ms=ms(lambda: rj_fn.warp(*gathered)),
        sample_ms=ms(lambda: rj_fn.sample(ux, uy, o.aux, True)),
        rj_ms=ms(lambda: rj_fn(*gathered)),
        solve_lam_ms=ms(lambda: solve.solve_lam(
            neq, float(cfg.init_lambda), free, cfg)),
    )
    phases["assembly_ms"] = phases["build_ms"] - phases["rj_ms"]
    lam = float(cfg.init_lambda)

    def one_iteration():
        _, neq_i = solve.build(problem, plan, cfg)
        dc, dp = solve.solve_lam(neq_i, lam, free, cfg)
        p_try = problem._replace(
            cam_states=cam_retract(problem.cam_states, dc),
            inv_depth=problem.inv_depth + dp)
        with fused.full_f32():
            return float(res_cost(p_try, cfg))      # the loop's host sync

    one_iteration()
    prof = profile_run(one_iteration, args.tries, device)
    prof["device_kernels_per_try"] = prof.pop("device_kernels_per_run")
    n_obs = int((o.valid != 0).sum())
    return dict(
        device=torch.cuda.get_device_name(device) if gpu else "cpu",
        solver=args.solver, K=int(problem.cam_states.pose.shape[0]),
        L=int(problem.inv_depth.shape[0]), observations=n_obs,
        rows=int(o.valid.shape[0]), H=H, W=W, reps=args.reps, **phases,
        tries=args.tries, **prof,
        peak_device_mib=(torch.cuda.max_memory_allocated(device) / 2**20
                         if gpu else None),
    )


def _report(result: dict, phases, prof: dict, tries: int, reps: int):
    gpu = result["device"] != "cpu"
    print(f"profile_solve ({result['solver']}): {result['device']}, "
          f"{result['K']} images of {result['H']}x{result['W']}, "
          f"{result['L']} landmarks, {result['observations']} observations")
    for k in phases:
        print(f"  {k} {result[k]:.4f} (mean of {reps})")
    print(f"  {tries} tries: wall {prof['wall_ms']:.3f} ms"
          + (f", device busy {prof['device_busy_ms']:.3f} ms "
             f"({100 * prof['device_busy_share']:.1f}%), "
             f"{prof['device_kernels_per_try']:.1f} device kernels per try"
             if gpu else ""))
    for name, (count, t) in prof["top_self_ms"].items():
        print(f"    {name}: {t:.3f} ms over {count} calls ({prof['top_by']})")
    print(json.dumps(result))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--solver", default="mega",
                    choices=("mega",) + FUSED_SOLVERS)
    for k in ("K", "L", "H", "W"):
        ap.add_argument(f"--{k}", type=int, default=EUROC[k])
    ap.add_argument("--obs-per-lm", type=int, default=EUROC["obs_per_lm"])
    ap.add_argument("--long-tracks", type=int, default=EUROC["long_tracks"])
    ap.add_argument("--tries", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = devices.resolve(args.device)
    gpu = device.type == "cuda"
    if args.solver in FUSED_SOLVERS:
        result = profile_fused(args, device)
        _report(result, ("build_ms", "warp_ms", "sample_ms", "rj_ms",
                         "assembly_ms", "solve_lam_ms"), result, args.tries,
                args.reps)
        return result

    pipe = synthetic.synth_pba_pipe(
        K=args.K, L=args.L, H=args.H, W=args.W, obs_per_lm=args.obs_per_lm,
        long_tracks=args.long_tracks, seed=SEED)
    model = pipe.calib.cam_types[0]
    if gpu:
        torch.cuda.reset_peak_memory_stats(device)
    problem, images_flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe, device=device)
    K = problem.cam_states.pose.shape[0]
    solve = pba_mega.make_mega_solver(model, images_flat, H, W, problem, K,
                                      device=device)
    cfg = ba.BAConfig(huber_delta=9.0)
    consts = solve.consts

    def ms(fn):
        return time_ms(fn, device, args.reps)

    ux, uy, _, GA, GB = pba_mega.warp_slabs(
        model, problem.cam_states, problem.inv_depth, consts)
    aff = pba_mega.affine_slab(problem.cam_states.affine, consts)
    _, neq = solve.build(problem, cfg)
    free = ~problem.fixed_cams
    phases = dict(
        build_ms=ms(lambda: solve.build(problem, cfg)),
        warp_slabs_ms=ms(lambda: pba_mega.warp_slabs(
            model, problem.cam_states, problem.inv_depth, consts)),
        megakernel_ms=ms(lambda: pba_mega.mega_rj(
            solve.images, ux, uy, GA, GB, consts.refp, aff, consts.iog,
            consts.cnt, cfg.huber_delta)),
        solve_lam_ms=ms(lambda: solve.solve_lam(
            neq, float(cfg.init_lambda), free, cfg)),
    )
    prof = profile_tries(solve, problem, cfg, args.tries, device)
    result = dict(
        device=torch.cuda.get_device_name(device) if gpu else "cpu",
        solver="mega", K=K, L=int(problem.inv_depth.shape[0]),
        observations=int(consts.cnt.sum()), Og=int(ux.shape[1]),
        H=H, W=W, reps=args.reps, **phases, **prof,
        peak_device_mib=(torch.cuda.max_memory_allocated(device) / 2**20
                         if gpu else None),
    )
    _report(result, phases, prof, args.tries, args.reps)
    return result


if __name__ == "__main__":
    main()
