"""The benchmark of the PyTorch port, one cell a run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/``: the
solver's settings and the driver under ``drivers/`` that calls the
program's entry), a traffic mix (``traffic/<name>.json``: the scene and
the per-request perturbation ``scenes.py`` makes from the seed) and has a
file of its own under ``cells/<name>.json`` (how many requests the trace
covers and the reference checks, and the limits of the checks).  Each
metric is read by ``metrics/<name>.py``.  Everything is found by name, so
a new cell or metric is new files and new entries in ``BENCHMARK.json``.

A run: set-up (the program imported and its kernel built or loaded from
``build/torch_kernels/``, the scene made from the seed, one request run to
warm up), then a closed loop of requests for ``--seconds`` (one client,
the next request sent when the last returns), then the reference checks
of a sample of the finished requests, drawn from the seed.  The last line
of standard output is the result as one JSON object; the numbers compared
and their limits are the last lines of standard error and the last key of
that object.  With ``--trace 1`` the first requests of the window run
under ``torch.profiler`` and the cell's per-layer metrics are reported
instead of its end-to-end ones.

It needs a CUDA card and exits 2 without one; it never falls back to the
CPU.  It exits 3 where the program cannot be imported, and 4 where the
program loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "photometric_bundle_adjustment_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "photometric_bundle_adjustment_tpu")
THREADS = 2
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def loaded_forbidden() -> list:
    """Modules whose top-level name is JAX's, its libraries' or the JAX
    package's (compared whole, so the port's own name does not match)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the specification, resolved by name
# ---------------------------------------------------------------------------


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read``."""
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        mod = _load_module(path, "benchmark_metric_" + metric.replace(
            ".", "_").replace("-", "_"))
        return mod.read

    def driver(self):
        return _load_module(
            self.root / "benchmark" / "drivers" / f"{self.config['driver']}.py",
            "benchmark_driver_" + self.config["driver"])

    root: Path = ROOT


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic, settings and metrics loaded."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    settings = json.loads(
        (root / "benchmark" / "cells" / f"{name}.json").read_text())
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                settings=settings,
                end_to_end=[m for m in spec["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if applies(m, name)],
                root=root)


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


@dataclass
class Run:
    """What the metric readers read: the window's requests (``latency``
    seconds from the call into the program to its answer on the host,
    ``outputs`` the driver's records), the window's length, the set-up,
    the window's peak memory and, traced, the ``trace`` of its first
    ``traced`` requests with the bytes of kernel #1's launches."""

    cell: str
    setup_s: float
    window_s: float = 0.0
    latency: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    peak_bytes: int = 0
    trace: object = None
    traced: int = 0
    launch_bytes: list = field(default_factory=list)


def _span(name):
    import torch

    return torch.profiler.record_function(name)


def window(cell: Cell, scene, driver, seconds: float, trace: bool,
           run: Run, device) -> None:
    """The closed loop: requests 1, 2, ... until ``seconds`` have passed;
    the first ``settings['trace_requests']`` of them under the profiler
    when ``trace``."""
    import torch

    n_traced = cell.settings["trace_requests"] if trace else 0
    prof = None
    if n_traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    i = 0
    at_least = cell.settings.get("min_requests", 1)
    while time.perf_counter() - t0 < seconds or i < at_least:
        i += 1
        with _span("request.prepare"):
            req = scene.request(i)
        ts = time.perf_counter()
        with _span(driver.span):
            out = driver.call(req)
        run.latency.append(time.perf_counter() - ts)
        run.outputs.append(out)
        if prof is not None and i == n_traced:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_traced = time.perf_counter() - t0
            prof.__exit__(None, None, None)
            done, prof = prof, None
    run.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        done, t_traced, n_traced = prof, run.window_s, i
    if n_traced:
        from benchmark import trace as tr

        run.trace = tr.from_profiler(done, t_traced)
        run.traced = n_traced


def sample(seed: int, indices: list, k: int) -> list:
    """``k`` of the request ``indices`` (or all), drawn from the seed."""
    import numpy as np

    rng = np.random.default_rng([int(seed), 0xC4EC, 0])
    pick = rng.choice(len(indices), size=min(k, len(indices)), replace=False)
    return sorted(indices[int(j)] for j in pick)


def aggregate(readings: list, limits) -> dict:
    """The numbers a run judges from per-request ``readings`` (dicts of
    number -> value): each number's worst (largest) reading, NaN reading
    as failing, and, for a limit named ``<number>.median``, the median of
    that number over the requests."""
    import statistics

    per = {}
    for nums in readings:
        for k, v in nums.items():
            v = float(v)
            per.setdefault(k, []).append(v if math.isfinite(v) else math.inf)
    out = {k: max(v) for k, v in per.items()}
    for name in limits:
        base, _, stat = name.rpartition(".")
        if stat == "median" and base in per:
            out[name] = statistics.median(per[base])
    return out


def checks(cell: Cell, scene, driver, run: Run, seed: int) -> dict:
    """The reference's numbers for ``settings['check_requests']`` finished
    requests, drawn from the seed, aggregated by ``aggregate``."""
    readings = []
    for i in sample(seed, list(range(1, len(run.outputs) + 1)),
                    cell.settings["check_requests"]):
        out = run.outputs[i - 1]
        readings.append(driver.compare(out, out["cost"],
                                       driver.reference(scene.request(i))))
    return aggregate(readings, cell.settings["limits"])


def spread_note(run: Run) -> str:
    """The window's request rate in each third of it, and the latency
    quartiles: where a run's pace changed (for the standard error)."""
    import statistics

    if len(run.latency) < 4:
        return ""
    ends, t = [], 0.0
    for x in run.latency:
        t += x
        ends.append(t)
    thirds = [sum(1 for e in ends if k * t / 3 < e <= (k + 1) * t / 3)
              for k in range(3)]
    q = statistics.quantiles(run.latency, n=4)
    note = (f"requests a third {thirds}, latency quartiles "
            f"{[round(x, 4) for x in q]} s")
    solve = sum(lv["solve_s"] for o in run.outputs
                for lv in o.get("levels", ()))
    if solve:
        note += f", the program's level solves {solve:.3f} s of {t:.3f} s"
    return note


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device=None, timing: dict | None = None) -> dict:
    """One run of ``cell`` on ``device`` (the card by default); returns
    the result object and fills ``timing`` with the seconds of set-up,
    window and checks."""
    import torch

    from benchmark import scenes

    device = torch.device(device or "cuda:0")
    gpu = device.type == "cuda"
    if gpu:
        torch.cuda.set_device(device)
    torch.set_num_threads(THREADS)
    driver = cell.driver().Driver(cell.config, device)
    scene = scenes.make_scene(cell.traffic, seed, device=device)
    driver.call(scene.request(0))                       # warm-up
    gc.collect()
    gc.freeze()         # set-up's objects out of the window's collections
    if gpu:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(cell=cell.name, setup_s=time.perf_counter() - T_START)

    window(cell, scene, driver, seconds, trace, run, device)
    if gpu:
        torch.cuda.synchronize(device)
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
        memory_peak = max(setup_peak, run.peak_bytes)
    else:
        memory_peak = 0
    failed = sum(1 for o in run.outputs if not math.isfinite(o["cost"]))
    if trace and hasattr(driver, "launch_bytes"):
        run.launch_bytes = [driver.launch_bytes(scene.request(i))
                            for i in range(1, run.traced + 1)]

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the reference runs after the window, its memory apart from the peak
    if gpu:
        torch.cuda.empty_cache()
    t_checks = time.perf_counter()
    worst = checks(cell, scene, driver, run, seed)
    t_checks = time.perf_counter() - t_checks
    limits = cell.settings["limits"]
    compared = {k: {"value": worst.get(k, math.inf), "limit": lim}
                for k, lim in limits.items()}
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in compared.values())
    result = {
        "correct": correct,
        "attempted": len(run.outputs),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if gpu else device.type,
            "kind": torch.cuda.get_device_name(device) if gpu else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.wall_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    if timing is not None:
        timing.update(setup_s=run.setup_s, window_s=run.window_s,
                      checks_s=t_checks, note=spread_note(run))
    result["readings"] = {k: v for k, v in worst.items() if k not in limits}
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    try:
        cell = resolve(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "cuda_cache"))
    for var in THREAD_VARS:         # one process, few threads
        os.environ[var] = str(THREADS)
    import torch

    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: the cell needs {need} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"benchmark: the program {PROGRAM} is not importable from "
              f"{Path.cwd()}", file=sys.stderr)
        return 3
    timing = {}
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      timing=timing)
    print(f"run: {result['attempted']} requests, set-up "
          f"{timing['setup_s']:.3f} s, window {timing['window_s']:.3f} s, "
          f"checks {timing['checks_s']:.3f} s; {timing['note']}",
          file=sys.stderr)
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
