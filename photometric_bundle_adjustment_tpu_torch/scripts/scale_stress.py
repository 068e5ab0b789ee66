"""Scale stress for the distributed BA paths.

    python -m photometric_bundle_adjustment_tpu_torch.scripts.scale_stress \\
        [--sizes small|medium|large|all] [--iters 2] [--device cuda|cpu] \\
        [--ranks 8]

Port of the root ``scripts/scale_stress.py``.  Runs synthetic problems of
increasing (K cameras, L landmarks, O observations) through the
landmark-sharded fused solver (``parallel/dist_fused``) on ``--ranks``
spawned ranks (``parallel/mesh.spawn``: NCCL where every rank owns a
card, Gloo where ranks share one or run on the CPU) in BOTH reduced-system
modes (replicated Cholesky and camera-row-partitioned matrix-free PCG),
and prints a table: observations, plan and solve seconds, the cost, the
CG iterations and rank 0's measured peak device MiB over the solve, with
the analytic per-device memory footprint of ``mem_model`` beside it.  The
JAX script runs 8 devices; ``--ranks 1`` gives the card the whole problem.

Per-device memory model (f32 words, D devices, C = camera tangent dim):
  observations:  O/D rows x (R*(2C+1) Jacobian + aux)     [build transient]
  landmark axis: L/D x (C + 3) reduction outputs + M: L/D x K*C
  reduced system:
    replicated:   K^2 C^2 (H_cc) + K^2 C^2 (S_corr0) + Cholesky factor
    partitioned:  K^2 C^2 / D row slice (+ K^2 C^2 assembly transient;
                  no S_corr0, no factor)
The model counts none of the chunk build's transients (the one-hot camera
lift and its per-chunk products), which the measured peak includes.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import NamedTuple

import torch

SIZES = {
    "small": (200, 8_192, 6),
    "medium": (512, 32_768, 8),
    "large": (1024, 98_304, 10),   # ~1M observations
}


def mem_model(K, L, O, D, C=6, R=2):
    W = R * (2 * C + 1)
    build = O // D * (W + 8)                      # Jacobians + aux rows
    m_mat = (L // D) * K * C
    rep = 2 * K * K * C * C + K * K * C * C       # H_cc + S_corr0 + factor
    part = K * K * C * C // D + K * K * C * C     # rows + assembly transient
    return {
        "build_MB": build * 4 / 1e6,
        "M_MB": m_mat * 4 / 1e6,
        "replicated_MB": rep * 4 / 1e6,
        "partitioned_MB": part * 4 / 1e6,
    }


class ScaleRun(NamedTuple):
    """One solve: the JAX script's ``run_one`` tuple (its first seven
    fields), rank 0's peak device bytes over the solve (0 on the CPU),
    whether every rank ended with bit-equal camera states, and the
    group's backend."""

    O: int
    prep_s: float
    solve_s: float
    initial_cost: float
    cost: float
    ok: bool
    cg: int
    peak_bytes: int
    ranks_bit_equal: bool
    backend: str


def run_one(K, L, obs_per_lm, mode, iters=2, *, ranks: int = 8,
            device="cuda", dtype=torch.float32) -> ScaleRun:
    """``synth_ba_problem("pinhole", K, L, obs_per_lm, pixel_noise=0.5)``
    in ``dtype``, planned on the host (``dist_fused.prepare``: ``prep_s``)
    and solved by ``iters`` LM iterations (Huber 1) of ``dist_fused`` on
    ``ranks`` ranks on ``device``, ``mode`` "replicated" or "partitioned"
    (PCG capped at 300 iterations a solve, relative tolerance 1e-7, as the
    JAX script).  ``solve_s`` is rank 0's solve, timed to a device sync;
    the ranks' start is not in it."""
    from photometric_bundle_adjustment_tpu_torch import device as devices
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.optim import ba
    from photometric_bundle_adjustment_tpu_torch.parallel import (
        dist_fused,
        mesh,
    )

    if mode not in ("replicated", "partitioned"):
        raise ValueError(f"mode {mode!r}: 'replicated' or 'partitioned'")
    device = devices.resolve(device)
    problem, _, _ = synthetic.synth_ba_problem(
        "pinhole", K, L, obs_per_lm, pixel_noise=0.5, dtype=dtype,
        device="cpu")
    O = problem.obs.anchor_cam.shape[0]
    t0 = time.perf_counter()
    sharded = dist_fused.prepare(problem, ranks)
    prep_s = time.perf_counter() - t0
    out = mesh.spawn(
        dist_fused.solve_rank, ranks, sharded,
        dist_fused.Family("geometric", "pinhole"),
        ba.BAConfig(max_iterations=iters, huber_delta=1.0),
        mode == "partitioned", 300, 1e-7, device=device, log=lambda s: None)
    c0, c1 = out["initial_cost"], out["cost"]
    ok = math.isfinite(c1) and c1 < c0
    return ScaleRun(O, prep_s, out["seconds"], c0, c1, ok,
                    int(out["cg_iterations"]), int(out["peak_bytes"]),
                    bool(out["ranks_bit_equal"]), out["backend"])


def main(argv=None) -> list:
    """Print the table; returns its rows as ``(size, mode, ScaleRun)``."""
    from photometric_bundle_adjustment_tpu_torch.parallel import mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="all",
                    choices=["all"] + list(SIZES))
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks of the group (the JAX script's mesh: 8)")
    args = ap.parse_args(argv)
    names = list(SIZES) if args.sizes == "all" else [args.sizes]

    backend, reason = mesh.backend_for(args.device, args.ranks)
    print(f"{args.ranks} rank(s) on {args.device}, backend {backend} "
          f"({reason})")
    print(f"{'size':>8} {'K':>5} {'L':>7} {'O':>8} {'mode':>12} "
          f"{'prep_s':>7} {'solve_s':>8} {'cost':>22} {'ok':>3} {'cg':>5} "
          f"{'peak_MiB':>9}")
    rows = []
    for name in names:
        K, L, opl = SIZES[name]
        for mode in ("replicated", "partitioned"):
            r = run_one(K, L, opl, mode, args.iters, ranks=args.ranks,
                        device=args.device)
            rows.append((name, mode, r))
            print(f"{name:>8} {K:>5} {L:>7} {r.O:>8} {mode:>12} "
                  f"{r.prep_s:>7.1f} {r.solve_s:>8.1f} "
                  f"{r.initial_cost:>10.3e}->{r.cost:<10.3e} "
                  f"{'Y' if r.ok else 'N'} {r.cg:>5} "
                  f"{r.peak_bytes / 2**20:>9.1f}")
        mm = mem_model(K, L, r.O, args.ranks)
        print(f"{'':>8} per-device MB: build={mm['build_MB']:.0f} "
              f"M={mm['M_MB']:.0f} reduced(repl)={mm['replicated_MB']:.0f} "
              f"reduced(part)={mm['partitioned_MB']:.0f}")
    return rows


if __name__ == "__main__":
    main()
