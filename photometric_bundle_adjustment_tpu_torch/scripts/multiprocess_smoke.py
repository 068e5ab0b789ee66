"""Multi-process distributed smoke test.

    python -m photometric_bundle_adjustment_tpu_torch.scripts.multiprocess_smoke \\
        [--procs 2] [--device cuda|cpu] [--timeout 480]

Port of the root ``scripts/multiprocess_smoke.py``.  The parent takes a
free TCP port and starts ``--procs`` OS processes with torchrun's own
variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); each joins one ``torch.distributed``
job through ``parallel/mesh.initialize_multihost`` (the store at
``env://``; NCCL where the host's processes each own a card, Gloo where
they share one or run on the CPU) and solves
``synth_ba_problem("pinhole", K=8, L=64, obs_per_landmark=4,
pixel_noise=0.5, seed=3)`` in f32 with ``BAConfig(max_iterations=4,
huber_delta=1.0)`` twice: alone (``fused.make_fused_ba_solver`` on
``fused.plan_for_problem``) and on the group (``dist_fused.prepare`` into
``WORLD_SIZE`` landmark shards, then ``dist_fused.solve_rank``), whose
collectives cross the process boundary.  Rank 0 prints both costs, ``OK``
when ``|c_d - c_s| <= 1e-4 |c_s| + 1e-9`` and ``MISMATCH`` otherwise, and
whether the ranks ended with bit-equal camera states.  A worker exits 1
on a mismatch or unequal ranks.  The parent waits for every worker under
``--timeout`` seconds (then kills the rest and fails), prints
``worker exit codes: [...]`` and exits 0 only if every worker did.

A process that finds ``RANK`` and ``WORLD_SIZE`` in its environment is a
worker, so the same module runs under torchrun, one host or several:

    torchrun --nproc-per-node N -m \\
        photometric_bundle_adjustment_tpu_torch.scripts.multiprocess_smoke \\
        [--device cuda|cpu]

The JAX script's ``--devices-per-proc`` adds fake CPU devices to each
process; here one process is one rank, so the group has ``--procs``
ranks.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import time

import torch

MODEL = "pinhole"
PROBLEM = dict(K=8, L=64, obs_per_landmark=4, pixel_noise=0.5, seed=3)
MAX_ITERATIONS, HUBER = 4, 1.0


def make_problem(device):
    """The JAX script's problem, in f32 on ``device``."""
    from photometric_bundle_adjustment_tpu_torch.models import synthetic

    problem, _, _ = synthetic.synth_ba_problem(
        model=MODEL, dtype=torch.float32, device=device, **PROBLEM)
    return problem


def config():
    from photometric_bundle_adjustment_tpu_torch.optim import ba

    return ba.BAConfig(max_iterations=MAX_ITERATIONS, huber_delta=HUBER)


def single_solve(problem):
    """The single-process reference: ``fused.make_fused_ba_solver`` (J by
    forward mode, as the JAX script builds it) on
    ``fused.plan_for_problem``.  Returns the BAResult."""
    from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
    from photometric_bundle_adjustment_tpu_torch.optim import fused

    solve = fused.make_fused_ba_solver(geometric_ba.make_residual_fn(MODEL),
                                       geometric_ba.cam_retract, 6)
    _, res = solve(problem, fused.plan_for_problem(problem), config())
    return res


def agree(c_d: float, c_s: float) -> bool:
    """The JAX script's rule for the distributed cost against one
    process's."""
    return abs(c_d - c_s) <= 1e-4 * abs(c_s) + 1e-9


def worker(device: str, timeout: float) -> int:
    import torch.distributed as dist

    from photometric_bundle_adjustment_tpu_torch.parallel import (
        dist_fused,
        mesh,
    )

    comm = mesh.initialize_multihost(
        device=device, timeout=datetime.timedelta(seconds=timeout))
    try:
        problem = make_problem(comm.device)
        c_s = float(single_solve(problem).cost)
        sharded = dist_fused.prepare(problem, comm.world)
        out = dist_fused.solve_rank(comm, sharded,
                                    dist_fused.Family("geometric", MODEL),
                                    config())
    finally:
        dist.destroy_process_group()
    c_d = out["cost"]
    ok = agree(c_d, c_s)
    if comm.rank == 0:
        print(f"[rank0] single cost {c_s:.6e} vs {comm.world}-process "
              f"distributed {c_d:.6e} -> {'OK' if ok else 'MISMATCH'}; "
              f"ranks_bit_equal {out['ranks_bit_equal']}; backend "
              f"{comm.backend}; device {comm.device}", flush=True)
    return 0 if ok and out["ranks_bit_equal"] else 1


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=480.0,
                    help="seconds the parent waits for every worker (and "
                         "each collective's timeout)")
    args = ap.parse_args(argv)

    from photometric_bundle_adjustment_tpu_torch import device as devices

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return worker(args.device, args.timeout)
    devices.resolve(args.device)

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = free_port()
    cmd = [sys.executable, "-m",
           "photometric_bundle_adjustment_tpu_torch.scripts.multiprocess_smoke",
           "--device", args.device, "--timeout", str(args.timeout)]
    procs = []
    for rank in range(args.procs):
        # the host's cores shared out, unless the caller set a count
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(args.procs),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(args.procs),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // args.procs)))
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=root,
            stdout=None if rank == 0 else subprocess.DEVNULL))
    deadline = time.monotonic() + args.timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                print(f"workers still ran after {args.timeout} s: killed",
                      flush=True)
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    print("worker exit codes:", rcs, flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
