"""The port's multi-process smoke (``scripts/multiprocess_smoke.py``) and
the device rule of ``parallel/mesh.initialize_multihost``.

* ``host_rule``'s cases: a process's backend and device follow its local
  rank and its host's process count against the host's cards
  (``torch.cuda.device_count`` monkeypatched), never its global rank;
  ``initialize_multihost`` joins with that device (the process group and
  the card selection stubbed).
* The script on the CPU: 2 and 4 OS processes joined through torchrun's
  variables at ``env://`` (4 is the JAX test's 2 processes x 2 devices),
  each run under a wall limit; the parent fails, and does not hang, when
  its workers outlive ``--timeout``.
* The worker's single-process cost against the JAX script's
  ``fused.make_fused_ba_solver`` on the same problem in f32.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from photometric_bundle_adjustment_tpu.models import geometric_ba as jgeo
from photometric_bundle_adjustment_tpu.models import synthetic as jsyn
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu.optim import fused as jfused
from photometric_bundle_adjustment_tpu_torch.parallel import mesh
from photometric_bundle_adjustment_tpu_torch.scripts import multiprocess_smoke

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODULE = "photometric_bundle_adjustment_tpu_torch.scripts.multiprocess_smoke"
WALL = 120

# (device, LOCAL_RANK, LOCAL_WORLD_SIZE, cards) -> (backend, device)
CASES = {
    "second_host_of_8_card_hosts": (("cuda", 1, 8, 8), ("nccl", "cuda:1")),
    "two_processes_one_card": (("cuda", 1, 2, 1), ("gloo", "cuda:0")),
    "cpu": (("cpu", 1, 4, 0), ("gloo", "cpu")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_rule(case, monkeypatch):
    (device, local_rank, local_world, cards), (backend, dev) = CASES[case]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got_backend, got_dev, _ = mesh.host_rule(device, local_rank, local_world)
    assert (got_backend, str(got_dev)) == (backend, dev)


@pytest.mark.parametrize("case", list(CASES))
def test_initialize_multihost_takes_the_local_device(case, monkeypatch):
    """Global rank 9 of 16: the rank never names the card."""
    (device, local_rank, local_world, cards), (backend, dev) = CASES[case]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    chosen, joined = [], []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw)))
    for k, v in (("RANK", 9), ("WORLD_SIZE", 16), ("LOCAL_RANK", local_rank),
                 ("LOCAL_WORLD_SIZE", local_world)):
        monkeypatch.setenv(k, str(v))
    comm = mesh.initialize_multihost(device=device, log=lambda s: None)
    assert (comm.backend, str(comm.device)) == (backend, dev)
    assert [str(d) for d in chosen] == ([dev] if device == "cuda" else [])
    assert [(b, kw["rank"], kw["world_size"]) for b, kw in joined] == [
        (backend, 9, 16)]


def _env():
    """This process's environment without torchrun's variables (the
    script is the parent), one thread a worker."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    return dict(env, OMP_NUM_THREADS="1")


@pytest.mark.parametrize("procs", [2, 4])
def test_script_on_cpu(procs):
    env = _env()
    out = subprocess.run(
        [sys.executable, "-m", MODULE, "--procs", str(procs), "--device",
         "cpu", "--timeout", str(WALL - 20)],
        capture_output=True, text=True, timeout=WALL, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"vs {procs}-process distributed" in out.stdout
    assert "-> OK; ranks_bit_equal True; backend gloo; device cpu" in out.stdout
    assert f"worker exit codes: {[0] * procs}" in out.stdout


def test_script_fails_when_workers_outlive_the_timeout():
    env = _env()
    out = subprocess.run(
        [sys.executable, "-m", MODULE, "--procs", "2", "--device", "cpu",
         "--timeout", "0.5"],
        capture_output=True, text=True, timeout=WALL, env=env, cwd=ROOT)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "workers still ran after 0.5 s: killed" in out.stdout
    assert "-> OK" not in out.stdout


def test_single_cost_matches_jax():
    """The worker's single-process solve against the JAX script's, on the
    same ``synth_ba_problem`` in f32."""
    jp, _, _ = jsyn.synth_ba_problem(model="pinhole", dtype=jnp.float32,
                                     **multiprocess_smoke.PROBLEM)
    cfg = jba.BAConfig(max_iterations=multiprocess_smoke.MAX_ITERATIONS,
                       huber_delta=multiprocess_smoke.HUBER)
    jsolve = jfused.make_fused_ba_solver(jgeo.make_residual_fn("pinhole"),
                                         jgeo.cam_retract, 6)
    _, jr = jsolve(jp, jfused.plan_for_problem(jp), cfg)

    tp = multiprocess_smoke.make_problem("cpu")
    assert tp.inv_depth.dtype == torch.float32
    tr = multiprocess_smoke.single_solve(tp)
    assert float(tr.initial_cost) == pytest.approx(float(jr.initial_cost),
                                                   rel=1e-4)
    assert float(tr.cost) == pytest.approx(float(jr.cost), rel=1e-4)
    assert float(tr.cost) < float(tr.initial_cost)
    assert multiprocess_smoke.agree(float(tr.cost), float(jr.cost))
