"""The port's benchmark (``photometric_bundle_adjustment_tpu_torch/bench.py``)
against the root ``bench.py``, on the CPU at tests/test_bench.py's sizes.

Each fixed step of the port (the geometric accelerator and host-plan
branches, the photometric gather and megakernel paths, the latter on the
kernel's plain version here) runs once from the JAX bench's problem,
moved through ``interop``, beside one step of the JAX bench's (the gather
path for the photometric step).  Held at the ROADMAP's tolerances: in f32
the cost to rtol 2e-4 and the state's move (updated cameras and inverse
depths less the initial ones) to atol 3e-3 x its max |ref| with rtol
2e-3; in f64, where the host-plan branch computes in full precision in
both packages, the cost to 1e-12 and the move to 1e-9 x its max |ref|
(the JAX accelerator branch runs its matmuls at f32 precision whatever
the dtype, so it keeps the f32 tolerances).

``main(device="cpu")`` runs at toy sizes (``TOY``, a keyword only tests
pass): the ``_cpu`` lines in the JAX main's order, strict JSON, the
headline last, exit 0; a failing builder gives an ``error`` line and exit
1.  ``workload_drift`` reads the port's counters under the one-sided row
rule; the committed ``runs/last_run_stats.json`` (the JAX package's TPU
run) is refused.  The bound counts of ``utils/roofline`` are held to
counts made by hand at toy shapes.
"""

import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench as jbench  # noqa: E402
from photometric_bundle_adjustment_tpu_torch import bench, interop  # noqa: E402
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega  # noqa: E402
from photometric_bundle_adjustment_tpu_torch.utils import roofline  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GEO = dict(K=6, L=64)
PBA = dict(K=12, L=48, obs_per_lm=3, H=64, W=96)
TOY = {"match": dict(I=8, F=128, C=2, MM=128, hyps=8), "pba": PBA,
       "step": GEO, "final": GEO, "detect": dict(H=64, W=96, B=2, F=128),
       "geometry": dict(M_loc=128, M_rows=256, hyps=8)}
# (cost rtol, move atol x max|ref|, move rtol)
F32_TOL = (2e-4, 3e-3, 2e-3)
F64_TOL = (1e-12, 1e-9, 0.0)
CPU_LINES = ["match_pairs_per_s_cpu", "pba_lm_iters_per_s_cpu",
             "keyframes_per_s_wall_est_cpu", "keyframes_per_s_cpu",
             "ba_lm_iters_per_s_cpu"]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _hold_step(jp, jnew, jcost, tp, tnew, tcost, tol):
    """The port's step from ``tp`` against the JAX step from ``jp``: the
    cost, and the move of every state array."""
    rtol, frac, mrtol = tol
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=rtol)
    leaves = lambda p: jax.tree_util.tree_leaves(  # noqa: E731
        (p.cam_states, p.inv_depth))
    for j0, j1, t0, t1 in zip(leaves(jp), leaves(jnew), leaves(tp),
                              leaves(tnew)):
        ref = np.asarray(j1, np.float64) - np.asarray(j0, np.float64)
        got = _np(t1).astype(np.float64) - _np(t0).astype(np.float64)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, atol=frac * np.abs(ref).max(),
                                   rtol=mrtol)


def _same_graph(tin, tp):
    """The JAX problem moved through interop has the port's own problem's
    observation graph and constants (the port's step closes over them)."""
    for name in ("anchor_cam", "target_cam", "landmark", "valid"):
        np.testing.assert_array_equal(_np(getattr(tin.obs, name)),
                                      _np(getattr(tp.obs, name)), name)
    for a, b in zip(tin.obs.aux, tp.obs.aux):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("host_plan,manual", [(True, True), (False, False)])
def test_build_step_and_time_iters(host_plan, manual):
    step, problem = bench.build_step(torch.float32, use_manual_jac=manual,
                                     host_plan=host_plan, device=CPU, **GEO)
    assert bench.time_iters(step, problem, 3, CPU) > 0.0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_build_pba_step_and_time_iters(use_kernel):
    step, problem = bench.build_pba_step(torch.float32, use_kernel=use_kernel,
                                         device=CPU, **PBA)
    assert bench.time_iters(step, problem, 3, CPU) > 0.0


@pytest.mark.parametrize("host_plan,dtype", [
    (True, "f64"), (True, "f32"), (False, "f64"), (False, "f32")])
def test_geometric_step_matches_jax_bench(host_plan, dtype):
    """One fixed step of each branch of ``build_step`` (the host-plan
    branch with the closed-form Jacobians, the accelerator branch with
    forward mode on the JAX side) from the JAX bench's problem."""
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    jstep, jp = jbench.build_step(jdt, use_manual_jac=host_plan,
                                  host_plan=host_plan, **GEO)
    tstep, tp = bench.build_step(tdt, use_manual_jac=host_plan,
                                 host_plan=host_plan, device=CPU, **GEO)
    tin = interop.geometric_problem_from_numpy(jp, CPU)
    _same_graph(tin, tp)
    jnew, jcost = jax.jit(jstep)(jp)
    tnew, tcost = tstep(tin)
    tol = F64_TOL if host_plan and dtype == "f64" else F32_TOL
    _hold_step(jp, jnew, jcost, tin, tnew, tcost, tol)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_photometric_step_matches_jax_bench(use_kernel):
    """One fixed step of ``build_pba_step`` (the gather solver, and the
    megakernel solver on the kernel's plain version) from the JAX bench's
    problem, against the JAX bench's gather step, f32."""
    jstep, jp, jconst = jbench.build_pba_step(jnp.float32, use_kernel=False,
                                              **PBA)
    tstep, tp = bench.build_pba_step(torch.float32, use_kernel=use_kernel,
                                     device=CPU, **PBA)
    tin = interop.problem_from_numpy(jp, CPU)
    _same_graph(tin, tp)
    jnew, jcost = jax.jit(jstep)(jp, jconst)
    tnew, tcost = tstep(tin)
    _hold_step(jp, jnew, jcost, tin, tnew, tcost, F32_TOL)


def _port_stats(**counters):
    """A stats record as the port's apps/sfm writes it, of a run with
    EUROC_WORKLOAD's counts (unpadded rows equal to the frozen ones)."""
    w = bench.EUROC_WORKLOAD
    c = {"detect_batches": w["detect_batches"], "match_pairs": 13_284,
         "stereo_pairs": 82, "localize_calls": w["localize_calls_1024"],
         "triangulate_rows": w["triangulate_rows"],
         "project_rows": w["project_rows"], "lmpos_rows": 0}
    c.update(counters)
    return {"n_images": w["images"], "device": "cpu", "backend": "cpu",
            "host_s": 7.0, "timings_s": {"ba_iters": w["ba_iters"]},
            "counters": c}


def test_workload_drift_guard():
    """The port's counter names map onto EUROC_WORKLOAD: matching counts
    do not drift; a count off by more than 15% does; a row count drifts
    above 15% over the frozen bucketed rows or below half of them, not in
    between (an unpadded run counts fewer rows)."""
    w = bench.EUROC_WORKLOAD
    assert bench.workload_drift(_port_stats()) == {}
    # 26,568 pairs in chunks of 32
    assert bench.workload_drift(_port_stats(match_pairs=2 * 13_284)) == {
        "match_chunks": (w["match_chunks"], 831)}
    assert list(bench.workload_drift(_port_stats(localize_calls=200))) == [
        "localize_calls_1024"]
    rows = w["project_rows"]
    for n, drifts in ((int(0.6 * rows), False), (int(0.4 * rows), True),
                      (int(1.1 * rows), False), (int(1.2 * rows), True)):
        drift = bench.workload_drift(_port_stats(project_rows=n))
        assert drift == ({"project_rows": (rows, n)} if drifts else {}), n
    assert list(bench.workload_drift(_port_stats(lmpos_rows=5))) == [
        "lmpos_rows"]


def test_anchored_inputs_put_the_world_points_in_place():
    """The geometry steps' anchors (pixel, intrinsics, pose, inverse
    depth) give back the JAX draws' world points through
    ``lm_positions``, points behind the origin's image plane included."""
    from photometric_bundle_adjustment_tpu_torch.pipeline import (
        sfm_pipeline as sp,
    )

    rng = np.random.default_rng(0)
    pts = rng.normal(0, 2.0, (256, 3)) + np.array([0, 0, 6.0])
    pts[0, 2] = -1.5
    intr = np.array([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0])
    args = [torch.as_tensor(np.ascontiguousarray(x))
            for x in bench._anchored(pts, intr)]
    np.testing.assert_allclose(_np(sp.lm_positions("pinhole", *args)), pts,
                               atol=1e-12)


def test_committed_tpu_stats_refused(tmp_path):
    """The committed runs/last_run_stats.json is the JAX package's TPU
    record: the port's bench refuses it; a record of the port's apps/sfm
    is read."""
    committed = ROOT / "runs" / "last_run_stats.json"
    assert json.loads(committed.read_text())["backend"] == "tpu"
    with pytest.raises(ValueError, match="not a stats record of the port"):
        bench.load_port_stats(committed)
    path = tmp_path / "stats.json"
    path.write_text(json.dumps(_port_stats()))
    assert bench.load_port_stats(path)["backend"] == "cpu"


def _lines(text):
    def no_constant(name):
        raise ValueError(f"not strict JSON: {name}")

    return [json.loads(line, parse_constant=no_constant)
            for line in text.splitlines()]


def test_main_on_cpu_at_toy_sizes(tmp_path, capsys):
    """``main(device="cpu")``: the JAX main's lines with ``_cpu`` names and
    the wall estimate of a port stats record, strict JSON, no error, the
    headline last, exit 0."""
    stats = tmp_path / "stats.json"
    stats.write_text(json.dumps(_port_stats()))
    assert bench.main("cpu", str(stats), sizes=TOY) == 0
    lines = _lines(capsys.readouterr().out)
    assert [x["metric"] for x in lines] == CPU_LINES
    for x in lines:
        assert "error" not in x, x
        assert math.isfinite(x["value"]) and x["value"] > 0, x
        assert (x["device"], x["power_limit_w"]) == ("cpu", None)
    kf = lines[3]
    assert set(kf["breakdown_s"]) == {"detect", "match", "localize",
                                      "triangulate", "project", "lmpos", "ba"}
    assert kf["host_s"] == 7.0
    assert lines[-1]["unit"] == "iters/s"


def test_main_failing_builder_exits_nonzero(monkeypatch, capsys):
    """A builder that raises gives its metric an ``error`` line; the run
    goes on, the composite that needs its time fails too, the committed
    TPU stats record is refused with an error line, and main returns 1."""
    def broken(**kwargs):
        raise RuntimeError("no chunk")

    monkeypatch.setattr(bench, "build_match_chunk", broken)
    rc = bench.main("cpu", str(ROOT / "runs" / "last_run_stats.json"),
                    sizes=TOY)
    assert rc == 1
    lines = _lines(capsys.readouterr().out)
    errors = {x["metric"]: x["error"] for x in lines if "error" in x}
    assert "no chunk" in errors.pop("match_pairs_per_s_cpu")
    assert "not a stats record" in errors.pop("keyframes_per_s_wall_est_cpu")
    assert "composite needs" in errors.pop("keyframes_per_s_cpu")
    assert errors == {}
    assert lines[-1]["metric"] == "ba_lm_iters_per_s_cpu"
    assert math.isfinite(lines[-1]["value"])


def test_main_without_cuda_raises():
    """On a host without CUDA the default device raises; nothing runs on
    the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()


# ---- the bound counts of utils/roofline, by hand at toy shapes ----

def test_sample_bound_by_hand():
    """Two observation columns (and one zero column), each with all 8
    points in one pixel cell: 4 texels each, one shared between them."""
    images = torch.zeros((2, 6, 8))
    ux = torch.tensor([[1.5] * 8, [2.5] * 8, [0.0] * 8]).T        # (P, N)
    uy = torch.tensor([[2.5] * 8, [2.5] * 8, [0.0] * 8]).T
    img = torch.tensor([0, 0, -1])
    # column 0 taps (1..2, 2..3), column 1 (2..3, 2..3): 6 distinct texels
    n_obs, n_pix = 2, 6
    nbytes = n_obs * (8 * 4 + 8 * 4 + 4) + n_pix * 4 + n_obs * 3 * 8 * 4
    lines = []
    ms = roofline.sample_bound_ms(images, ux, uy, img, log=lines.append)
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12)
    assert lines == [f"  bound: {nbytes / 1e6:.2f} MB (2 observations x 68 "
                     f"B, 6 image pixels, output {192 / 1e6:.2f} MB) at "
                     f"3.35 TB/s"]


def test_mega_bound_by_hand():
    """The megakernel's bound on a toy problem: its columns' bytes (176
    each), the state, the texels its taps touch (counted here point by
    point from the warp) and its payload."""
    from photometric_bundle_adjustment_tpu_torch.models import synthetic

    problem, images_flat, H, W = synthetic.euroc_scale_pba(
        K=10, L=6, obs_per_lm=2, H=32, W=48, device=CPU)
    solver = pba_mega.make_mega_solver("pinhole", images_flat, H, W, problem,
                                       device=CPU)
    c, cams, rho = solver.consts, problem.cam_states, problem.inv_depth
    ux, uy, _, _, _ = pba_mega.warp_slabs("pinhole", cams, rho, c)
    texels = set()
    for n in range(c.timg.shape[0]):
        if int(c.timg[n]) < 0:
            continue
        for p in range(pba_mega.P):
            x = int(math.floor(min(max(float(ux[p, n]), 0), W - 1.001)))
            y = int(math.floor(min(max(float(uy[p, n]), 0), H - 1.001)))
            texels |= {(int(c.timg[n]), y + dy, x + dx)
                       for dy in (0, 1) for dx in (0, 1)}
    n_obs = int((c.timg >= 0).sum())
    assert n_obs == 12
    state = 4 * (10 * 7 + 10 * 2 + 6)
    nbytes = n_obs * (16 + 96 + 32 + 32) + state + 4 * len(texels) \
        + n_obs * 184 * 4
    ms = roofline.mega_bound_ms("pinhole", solver.images, cams, rho, c)
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12)


def test_hamming_bound_by_hand():
    """A stack of four images of 4 descriptor slots with 4, 2, 3 and 4
    valid, pairs (0, 1) and (1, 2): 8 + 6 distances of 512 operations
    against the bytes of the three images the pairs touch (descriptors
    and masks), the indices and the outputs, bytes-bound; then two full
    images of 128 slots, one pair: 128^2 distances, bound by the
    operations at the int8 peak (faster than a b1 rate of 1e15) or at a
    b1 rate above it."""
    valid = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 0],
                          [1, 1, 1, 1]], dtype=torch.bool)
    a, b = torch.tensor([0, 1]), torch.tensor([1, 2])
    nbytes = 3 * 4 * 33 + 2 * 2 * 4 * 2 + 2 * 3 * 4 * 2 * 4
    assert (14 * 512) / 1.979e15 < nbytes / 3.35e12
    ms, by = roofline.hamming_bound_ms(valid, a, b, 4, 1e15)
    assert (ms, by) == (pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12),
                        "bytes")
    valid = torch.ones((2, 128), dtype=torch.bool)
    a, b = torch.tensor([0]), torch.tensor([1])
    ops = 128 * 128 * 512
    assert ops / 1.979e15 > (2 * 128 * 33 + 16 + 24 * 128) / 3.35e12
    ms, by = roofline.hamming_bound_ms(valid, a, b, 128, 1e15)
    assert (ms, by) == (pytest.approx(1e3 * ops / 1.979e15, rel=1e-12),
                        "operations")
    ms, _ = roofline.hamming_bound_ms(valid, a, b, 128, 2.2e15)
    assert ms == pytest.approx(1e3 * ops / 2.2e15, rel=1e-12)


def test_schur_step_ops_by_hand():
    assert roofline.schur_step_ops(10, 12) == (2 * 10 * 144, 1728 / 3)


# ---------------------------------------------------------------------------
# the CPU-baseline contract (bench._cpu_baselines), its subprocess stubbed
# ---------------------------------------------------------------------------

COMMITTED_CPU_BASELINE = ROOT / "runs" / "cpu_baseline.json"
CPU_STDOUT = ("timing the plain path\nCPU_DT 0.125\nCPU_PBA_DT 6.25e-02\n"
              "CPU_MATCH_DT 1.5\n")


@pytest.fixture
def cpu_baseline_env(monkeypatch, tmp_path):
    """``CPU_CACHE`` in ``tmp_path``, the subprocess stubbed (its calls and
    every path ``bench`` opens recorded); afterwards the committed
    ``runs/cpu_baseline.json`` (the JAX package's) was neither opened nor
    changed."""
    import subprocess
    import types

    stat, data = COMMITTED_CPU_BASELINE.stat(), COMMITTED_CPU_BASELINE.read_bytes()
    env = types.SimpleNamespace(stdout=CPU_STDOUT, calls=[], opened=[],
                                cache=tmp_path / "runs" / "cpu.json")

    def run(cmd, **kw):
        env.calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, env.stdout, "stderr text")

    def recording_open(path, *a, **kw):
        env.opened.append(Path(path).resolve())
        return open(path, *a, **kw)

    monkeypatch.setattr(bench, "subprocess", types.SimpleNamespace(run=run))
    monkeypatch.setattr(bench, "open", recording_open, raising=False)
    monkeypatch.setattr(bench, "CPU_CACHE", str(env.cache))
    yield env
    assert COMMITTED_CPU_BASELINE.resolve() not in env.opened
    assert COMMITTED_CPU_BASELINE.read_bytes() == data
    assert COMMITTED_CPU_BASELINE.stat().st_mtime_ns == stat.st_mtime_ns


def test_cpu_baselines_parse_the_tags_and_cache(cpu_baseline_env):
    env = cpu_baseline_env
    values, err = bench._cpu_baselines()
    assert values == {"ba": 0.125, "pba": 0.0625, "match": 1.5} and err == ""
    assert env.calls == [[sys.executable, "-m",
                          "photometric_bundle_adjustment_tpu_torch.bench",
                          "--cpu-baseline"]]
    with open(env.cache) as f:
        assert json.load(f) == {"version": bench.CPU_BASELINE_VERSION,
                                "values": values}
    # a second call reads the cache and starts no subprocess
    env.stdout = ""
    assert bench._cpu_baselines() == (values, "")
    assert len(env.calls) == 1


@pytest.mark.parametrize("stdout", [
    "CPU_DT 0.125\nCPU_PBA_DT_ERROR RuntimeError('no')\nCPU_MATCH_DT 1.5\n",
    "CPU_DT 0.125\nCPU_MATCH_DT 1.5\n"], ids=["error_tag", "missing_tag"])
def test_cpu_baselines_failed_value_is_nan_and_not_cached(cpu_baseline_env,
                                                          stdout):
    env = cpu_baseline_env
    env.stdout = stdout
    values, err = bench._cpu_baselines()
    assert values["ba"] == 0.125 and values["match"] == 1.5
    assert math.isnan(values["pba"])
    assert err.endswith("stderr text") and "CPU_DT 0.125" in err
    assert not env.cache.exists()


def test_cpu_baselines_ignore_another_version(cpu_baseline_env):
    env = cpu_baseline_env
    env.cache.parent.mkdir(parents=True)
    env.cache.write_text(json.dumps({
        "version": bench.CPU_BASELINE_VERSION + 1,
        "values": {"ba": 9.0, "pba": 9.0, "match": 9.0}}))
    values, err = bench._cpu_baselines()
    assert values == {"ba": 0.125, "pba": 0.0625, "match": 1.5} and err == ""
    assert len(env.calls) == 1
    with open(env.cache) as f:
        assert json.load(f)["version"] == bench.CPU_BASELINE_VERSION


def test_cpu_baseline_cache_is_not_the_committed_record():
    assert Path(bench.CPU_CACHE).name != COMMITTED_CPU_BASELINE.name
    assert Path(bench.CPU_CACHE).parent == Path("runs")
