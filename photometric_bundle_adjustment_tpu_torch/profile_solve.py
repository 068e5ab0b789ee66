"""Where the time of one LM try goes, at full resolution.

    python3 -m photometric_bundle_adjustment_tpu_torch.profile_solve \
        [--solver {mega,fused,kernel_fused,kernel_dense,geo}] \
        [--family {chunk,dense}] [--bf16]

``--solver mega`` (the default) profiles the megakernel solver
``make_mega_solver``.  Its chunk family (``--family chunk``, the default)
runs on the synthetic EuRoC-scale map ``EUROC`` (164 images of 480x752,
about 4.8k landmarks, about 30k observations, seed 0; ``chip_smoke.py``
drives the same map) with the level-0 solver ``refine_photometric`` would
build for it; its dense slot-major family (``--family dense``) on
``synthetic.euroc_scale_pba`` reordered by ``densify_problem`` (the
workload of the JAX package's ``bench.py`` ``pba_lm``).  ``--bf16`` runs
the kernel's bf16 tier.  It warms up and then, at the initial state:

  * times each piece of a try, mean of ``--reps`` calls (CUDA events on a
    GPU, the host clock on the CPU): the whole build (the megakernel, which
    computes the warp inside it, and the family's assembly), the megakernel
    alone, the assembly (the build less the kernel) and the damped solve
    (``fused.solve_lam``); for the chunk family also the
    fixed-order sums of its plan against the scatter-adds they replace
    (``fixed_order_sums``);
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
  * ``kernel_fused``: ``make_kernel_fused_solver`` on the problem's own
    rows (patch kernel, chunk build), the counterpart of
    ``profile_pba.py:main_kernel``;
  * ``kernel_dense``: ``make_kernel_dense_solver`` on ``densify_problem``
    (patch kernel, slot-major dense build), the counterpart of
    ``scripts/profile_pba_dense.py``.

For them it times the build, its pieces (the warp with its Jacobian
terms, the sampler, the whole batched rj function; the assembly is the
build less rj) and ``solve_lam``, then profiles ``--tries`` accepted
iterations of the classic LM loop (build, damped solve, retraction,
residual pass, host sync of the cost) the same way.

``--solver geo`` profiles geometric BA (``ops/geo_mega.make_geo_solver``)
on ``synthetic.synth_ba_problem`` at the size of the JAX package's
``bench.py`` workload (pinhole, K=200, L=8192, 6 observations per
landmark, 0.3 px noise, f32: 49,152 observations), in the dense
slot-major family (``--family dense``, the default here, as bench.py) or
the chunk family.  It times the build, the payload plane
(``_geo_payload``), the assembly (the build less the payload), the Schur
Gram, the damped solve and the Cholesky of the damped system alone, and
the fixed LM step of bench.py (build, damped solve at lambda 1e-4,
retraction; no accept test): N chained steps less one step, over N - 1,
and ``geo_lm_iters_per_s`` from it; on the card, in the dense family,
also the same step from one CUDA graph of 20 steps (``graph_ms``), which
takes the host's launches out of the time.  Then ``--tries`` fixed steps
run under the profiler (one host sync at the end).

Prints one JSON object with every number as its last line.  ``--device
cpu`` with small ``--K/--L/--H/--W`` runs the same code on the plain path.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.models.photometric_ba import (
    cam_retract,
)
from photometric_bundle_adjustment_tpu_torch.ops import geo_mega, pba_mega
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
from photometric_bundle_adjustment_tpu_torch.utils import spans


# The EuRoC-scale synthetic map: V1's image count, size and camera model,
# about 4.8k landmarks and 30k observations with a heavy tail of tracks.
EUROC = dict(K=164, L=4800, H=480, W=752, obs_per_lm=5, long_tracks=200)
SEED = 0
# bench.py's geometric BA workload (bench.py:38-109)
GEO = dict(K=200, L=8192, obs_per_lm=6)
GEO_PIXEL_NOISE = 0.3


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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn`` on the current CUDA device:
    ``reps`` calls captured in one CUDA graph, replayed ``replays`` times
    between CUDA events, so neither the host's launch rate nor the
    wrapper's Python enters the time.  ``fn`` must not sync the host; it
    runs once on a side stream before the capture (loading its kernel's
    module), and the launch counts see that call and the captured calls,
    not the replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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
    the host off the card).  User annotations (the program's spans, on the
    host and on the device timeline) are neither kernels nor operators."""
    from torch.profiler import ProfilerActivity, profile

    gpu = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if gpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not spans.is_annotation(e)]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    key = "self_device_time_total" if gpu else "self_cpu_time_total"
    ops = sorted((e for e in prof.key_averages()
                  if not spans.is_annotation(e)),
                 key=lambda e: getattr(e, key), reverse=True)[:top]
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


def fixed_order_sums(plan, K: int, L: int, device: torch.device,
                     ms) -> dict:
    """What the fixed-order sums of a chunk-family build cost: the sums of
    its plan (the pair-chunk blocks into K*K, the landmark chunks at the
    widths C+2 and K*C, the two camera chunks at C) on random values of
    the build's shapes, through ``fused.tree_sum``
    (``fixed_sums_ms``) and through ``index_add_``, the scatter-add they
    replace (``scatter_sums_ms``), each the sum of its calls' ``ms``."""
    C = 8
    gen = torch.Generator().manual_seed(SEED)
    cases = [(plan.cc_seg, plan.cc_rows4.reshape(-1), K * K, C * C),
             (plan.lm.seg, plan.lm.rows, L, C + 2),
             (plan.lm.seg, plan.lm.rows, L, K * C),
             (plan.gc_a.seg, plan.gc_a.rows, K, C),
             (plan.gc_t.seg, plan.gc_t.rows, K, C)]
    fixed = scatter = 0.0
    for tree, rows, n, width in cases:
        vals = torch.randn((rows.shape[0], width), generator=gen).to(device)
        fixed += ms(lambda: fused.tree_sum(vals, tree))
        scatter += ms(lambda: torch.zeros((n + 1, width), device=device)
                      .index_add_(0, rows, vals)[:n])
    return dict(fixed_sums_ms=fixed, scatter_sums_ms=scatter)


FUSED_SOLVERS = ("fused", "kernel_fused", "kernel_dense")


def fused_case(solver: str, problem: ba.BAProblem, images_flat, H: int,
               W: int, device: torch.device):
    """``(solve, problem2, plan)``: the solver of ``--solver`` on the
    problem in the order and with the plan it takes (chunk plans without
    power-of-two buckets)."""
    if solver == "fused":
        return (pba.make_fused_solver("pinhole", images_flat, H, W,
                                      device=device), problem,
                fused.plan_for_problem(problem, pow2_buckets=False))
    if solver == "kernel_fused":
        return (pba.make_kernel_fused_solver("pinhole", images_flat, H, W,
                                             problem, device=device), problem,
                fused.plan_for_problem(problem, pow2_buckets=False))
    p2, plan = fused.densify_problem(problem, pow2_buckets=False)
    return (pba.make_kernel_dense_solver("pinhole", images_flat, H, W, p2,
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


def geo_fixed_step(solve, problem: ba.BAProblem, cfg: ba.BAConfig,
                   lam: float = 1e-4):
    """bench.py's fixed LM step of a ``make_geo_solver`` solve: build,
    damped solve at ``lam``, retraction; no accept test and no host
    sync.  Returns ``step(problem) -> (problem, cost)``."""
    free = ~problem.fixed_cams

    def step(p):
        cost, neq = solve.build(p, cfg)
        dc, dp = solve.solve_lam(neq, lam, free, cfg)
        return p._replace(
            cam_states=geometric_ba.cam_retract(p.cam_states, dc),
            inv_depth=p.inv_depth + dp), cost

    return step


def fixed_step_ms(step, problem, n: int, device: torch.device,
                  reps: int = 3) -> float:
    """Milliseconds of one fixed step: ``n`` chained steps less one step,
    over n - 1 (each the mean of ``reps`` runs; CUDA events on a GPU, the
    host clock on the CPU), so the set-up and the drain of a run cancel."""
    def run(k):
        p = problem
        for _ in range(k):
            p, cost = step(p)
        return cost

    def ms(k):
        return time_ms(lambda: run(k), device, reps=reps, warmup=1)

    return (ms(n) - ms(1)) / (n - 1)


def profile_geo(args, device: torch.device) -> dict:
    """Phase times, the fixed step and the profiled steps of the geometric
    solver (``--solver geo``)."""
    gpu = device.type == "cuda"
    if gpu:
        torch.cuda.reset_peak_memory_stats(device)
    problem, _, _ = synthetic.synth_ba_problem(
        "pinhole", K=args.K, L=args.L, obs_per_landmark=args.obs_per_lm,
        seed=SEED, pixel_noise=GEO_PIXEL_NOISE, dtype=torch.float32,
        device=device)
    n_obs = int(problem.obs.valid.shape[0])
    if args.family == "dense":
        problem, plan_slot = fused.densify_problem(problem,
                                                   pow2_buckets=False)
    else:
        plan_slot = None
    solve = geo_mega.make_geo_solver("pinhole", problem, plan_slot,
                                     device=device)
    cfg = ba.BAConfig(max_iterations=1, huber_delta=1.0)
    free = ~problem.fixed_cams
    _, neq = solve.build(problem, cfg)
    lam = float(cfg.init_lambda)

    def ms(fn):
        return time_ms(fn, device, args.reps)

    def gram():
        M = neq[6]
        with fused.full_f32():
            return (M * neq[7][:, None]).T @ M       # S_corr0 of the build

    def damped_system():
        H = neq[0]
        d = torch.clamp(torch.diagonal(H), 1e-12, 1e32)
        return H + torch.diag(lam * d) - neq[1] / (1.0 + lam)

    S_lam = damped_system()
    phases = dict(
        build_ms=ms(lambda: solve.build(problem, cfg)),
        payload_ms=ms(lambda: geo_mega._geo_payload(
            "pinhole", problem, solve.consts, cfg)),
        gram_ms=ms(gram),
        solve_lam_ms=ms(lambda: solve.solve_lam(neq, lam, free, cfg)),
        cholesky_ms=ms(lambda: torch.linalg.cholesky_ex(S_lam)),
    )
    phases["assembly_ms"] = phases["build_ms"] - phases["payload_ms"]
    step = geo_fixed_step(solve, problem, cfg)
    phases["fixed_step_ms"] = fixed_step_ms(step, problem, args.steps,
                                            device)
    phases["geo_lm_iters_per_s"] = 1e3 / phases["fixed_step_ms"]
    if gpu and plan_slot is not None:
        # the same step from one CUDA graph: no host launches in the time
        phases["fixed_step_graph_ms"] = graph_ms(lambda: step(problem)[1])
        phases["geo_lm_iters_per_s_graph"] = 1e3 / phases["fixed_step_graph_ms"]

    def steps():
        p = problem
        for _ in range(args.tries):
            p, cost = step(p)
        return float(cost)                  # one host sync at the end

    steps()
    prof = profile_run(steps, 1, device)
    runs = prof.pop("device_kernels_per_run")
    prof["device_kernels_per_try"] = (runs / args.tries if runs is not None
                                      else None)
    return dict(
        device=torch.cuda.get_device_name(device) if gpu else "cpu",
        solver="geo", family=args.family, K=int(args.K),
        L=int(problem.inv_depth.shape[0]), observations=n_obs,
        rows=int(problem.obs.valid.shape[0]),
        columns=int(solve.consts.valid.shape[0]), reps=args.reps,
        steps=args.steps, **phases, tries=args.tries, **prof,
        peak_device_mib=(torch.cuda.max_memory_allocated(device) / 2**20
                         if gpu else None),
    )


def _report(result: dict, phases, prof: dict, tries: int, reps: int):
    gpu = result["device"] != "cpu"
    family = (f", {result['family']} family"
              f"{', bf16 tier' if result.get('bf16') else ''}"
              if "family" in result else "")
    images = (f"{result['K']} images of {result['H']}x{result['W']}"
              if "H" in result else f"{result['K']} cameras")
    print(f"profile_solve ({result['solver']}{family}): {result['device']}, "
          f"{images}, {result['L']} landmarks, "
          f"{result['observations']} observations")
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
                    choices=("mega",) + FUSED_SOLVERS + ("geo",))
    for k in ("K", "L", "H", "W"):
        ap.add_argument(f"--{k}", type=int)
    ap.add_argument("--obs-per-lm", type=int)
    ap.add_argument("--long-tracks", type=int, default=EUROC["long_tracks"])
    ap.add_argument("--family", choices=("chunk", "dense"),
                    help="default: dense for --solver geo, else chunk")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--tries", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=50,
                    help="chained fixed steps timed by --solver geo")
    args = ap.parse_args(argv)
    # sizes default to the workload of the solver profiled
    sizes = GEO if args.solver == "geo" else EUROC
    for k in ("K", "L", "H", "W", "obs_per_lm"):
        if getattr(args, k) is None:
            setattr(args, k, sizes.get(k))
    if args.family is None:
        args.family = "dense" if args.solver == "geo" else "chunk"
    device = devices.resolve(args.device)
    gpu = device.type == "cuda"
    if args.solver == "geo":
        result = profile_geo(args, device)
        _report(result, [k for k in (
            "build_ms", "payload_ms", "assembly_ms", "gram_ms",
            "solve_lam_ms", "cholesky_ms", "fixed_step_ms",
            "geo_lm_iters_per_s", "fixed_step_graph_ms",
            "geo_lm_iters_per_s_graph") if k in result], result, args.tries,
                args.reps)
        return result
    if args.solver in FUSED_SOLVERS:
        result = profile_fused(args, device)
        _report(result, ("build_ms", "warp_ms", "sample_ms", "rj_ms",
                         "assembly_ms", "solve_lam_ms"), result, args.tries,
                args.reps)
        return result

    if gpu:
        torch.cuda.reset_peak_memory_stats(device)
    if args.family == "dense":
        model = "pinhole"
        problem, images_flat, H, W = synthetic.euroc_scale_pba(
            K=args.K, L=args.L, obs_per_lm=args.obs_per_lm, H=args.H,
            W=args.W, seed=SEED, device=device)
        problem, plan_slot = fused.densify_problem(problem, pow2_buckets=False)
    else:
        pipe = synthetic.synth_pba_pipe(
            K=args.K, L=args.L, H=args.H, W=args.W,
            obs_per_lm=args.obs_per_lm, long_tracks=args.long_tracks,
            seed=SEED)
        model = pipe.calib.cam_types[0]
        problem, images_flat, H, W, _, _ = \
            pba_refine.build_photometric_problem(pipe, device=device)
        plan_slot = None
    K = problem.cam_states.pose.shape[0]
    solve = pba_mega.make_mega_solver(model, images_flat, H, W, problem,
                                      plan_slot, device=device)
    cfg = ba.BAConfig(huber_delta=9.0, sample_bf16=args.bf16)
    consts = solve.consts
    images = solve.stack(cfg)

    def ms(fn):
        return time_ms(fn, device, args.reps)

    _, neq = solve.build(problem, cfg)
    free = ~problem.fixed_cams
    phases = dict(
        build_ms=ms(lambda: solve.build(problem, cfg)),
        megakernel_ms=ms(lambda: pba_mega.mega_fused(
            model, images, problem.cam_states, problem.inv_depth, consts,
            cfg.huber_delta)),
    )
    phases["assembly_ms"] = phases["build_ms"] - phases["megakernel_ms"]
    if plan_slot is None:
        phases.update(fixed_order_sums(solve.plan, K, problem.inv_depth.shape[0],
                                       device, ms))
    phases["solve_lam_ms"] = ms(lambda: solve.solve_lam(
        neq, float(cfg.init_lambda), free, cfg))
    prof = profile_tries(solve, problem, cfg, args.tries, device)
    result = dict(
        device=torch.cuda.get_device_name(device) if gpu else "cpu",
        solver="mega", family=args.family, bf16=args.bf16, K=K,
        L=int(problem.inv_depth.shape[0]),
        observations=int((consts.timg >= 0).sum()),
        columns=int(consts.cols.shape[1]),
        H=H, W=W, reps=args.reps, **phases, **prof,
        peak_device_mib=(torch.cuda.max_memory_allocated(device) / 2**20
                         if gpu else None),
    )
    _report(result, phases, prof, args.tries, args.reps)
    return result


if __name__ == "__main__":
    main()
