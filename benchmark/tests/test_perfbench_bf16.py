"""The ``pba-room164-bf16`` cell's pieces on the CPU: the bf16 driver's
bytes and its refusal of a float32 configuration, the two readers it
adds, and a toy version of the cell with the real cell's limits, run once
sound and once with a solve that returns its start (the pattern of
``test_perfbench_faults.py``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run as bench, scenes
from benchmark.trace import Trace

torch.set_num_threads(1)
ROOT = bench.ROOT
CELL = "pba-room164-bf16"
TOY_TRAFFIC = {"scene": "room", "params": dict(
    K=12, L=300, H=96, W=128, obs_per_lm=5, long_tracks=20, max_track=10,
    model="ds", trans_noise=0.02, rot_noise=0.002, depth_noise=0.03,
    keep=0.95)}


def _drivers():
    cell = bench.resolve(CELL)
    f32_cell = bench.resolve("pba-room164-f32")
    cpu = torch.device("cpu")
    return (cell.driver().Driver(cell.config, cpu),
            f32_cell.driver().Driver(f32_cell.config, cpu), cell)


def test_bf16_bytes_are_the_f32_bytes_less_2_a_texel():
    from benchmark import roofline
    from benchmark.reference import photometric

    bf16, f32, cell = _drivers()
    req = scenes.make_scene(TOY_TRAFFIC, 2 ** 33 + 5).request(1)
    got, base = bf16.launch_bytes(req), f32.launch_bytes(req)
    prob = photometric.MapProblem(req, torch.device("cpu"), torch.float32)
    pyr = photometric.pyramid(prob.images, cell.config["levels"])
    texels = [torch.unique(roofline.touched_texels(
        prob, pyr[lv], lv, prob.cams0, prob.rho0)).numel()
        for lv in range(cell.config["levels"] - 1, -1, -1)]
    assert len(got) == len(base) == cell.config["levels"]
    assert all(n > 0 for n in texels)
    assert got == [b - 2 * n for b, n in zip(base, texels)]


def test_bf16_driver_refuses_a_float32_configuration():
    bf16_cell = bench.resolve(CELL)
    f32_cell = bench.resolve("pba-room164-f32")
    with pytest.raises(ValueError, match="sample_bf16"):
        bf16_cell.driver().Driver(f32_cell.config, torch.device("cpu"))


def _run(traced: bool, levels: list, kernels=()) -> bench.Run:
    run = bench.Run(cell=CELL, setup_s=1.0, window_s=2.0,
                    latency=[1.0, 1.0],
                    outputs=[dict(levels=levels, tries=7)] * 2)
    if traced:
        run.trace = Trace(kernels=list(kernels), wall_s=1.0)
        run.traced = 1
        run.launch_bytes = [[1000, 2000]]
    return run


@pytest.mark.parametrize("metric", ["pba.stack_ms", "pba_mega_bf16_roofline"])
def test_readers_give_none_untraced_and_without_stack_s(metric):
    read = bench.resolve(CELL).reader(metric)
    with_stack = [dict(tries=3, stack_s=1e-4, setup_s=1e-3, solve_s=0.1),
                  dict(tries=4, stack_s=2e-4, setup_s=1e-3, solve_s=0.1)]
    assert read(_run(False, with_stack)) is None
    if metric == "pba.stack_ms":
        no_stack = [{k: v for k, v in lv.items() if k != "stack_s"}
                    for lv in with_stack]
        assert read(_run(True, no_stack)) is None
        assert read(_run(True, with_stack)) == pytest.approx(0.3)
    else:
        assert read(_run(True, with_stack)) is None        # no kernel


def test_roofline_reads_the_bf16_instantiation():
    read = bench.resolve(CELL).reader("pba_mega_bf16_roofline")
    levels = [dict(tries=3), dict(tries=4)]
    ns = "(anonymous namespace)::"
    named = [(f"void {ns}mega_kernel<2, __nv_bfloat16>(...)", 0.0, 10.0),
             (f"void {ns}mega_kernel<2, float>(...)", 10.0, 1000.0),
             ("void at::native::gather(...)", 0.0, 500.0)]
    need = 4 * 1000 + 5 * 2000
    assert read(_run(True, levels, named)) == pytest.approx(
        100.0 * need / 3.35e12 / 10e-6)
    assert read(_run(True, levels, named[1:])) is None    # f32 tier only


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    """A checkout-like root with a toy of the cell, added as new files:
    the real cell's limits and configuration on a 12-image room."""
    tmp = tmp_path_factory.mktemp("bf16toy")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    settings = json.loads(
        (ROOT / "benchmark" / "cells" / f"{CELL}.json").read_text())
    settings.update(check_requests=2, min_requests=2, trace_requests=1)
    (tmp / "benchmark" / "cells" / "bf16-toy.json").write_text(
        json.dumps(settings))
    (tmp / "benchmark" / "traffic" / "bf16-toy.json").write_text(
        json.dumps(TOY_TRAFFIC))
    w = next(x for x in spec["workloads"] if x["name"] == CELL)
    spec["workloads"].append(dict(w, name="bf16-toy", traffic="bf16-toy"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("bf16-toy")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def _toy(root, trace=False) -> dict:
    return bench.run_cell(bench.resolve("bf16-toy", root), 2 ** 33 + 17,
                          0.1, trace=trace, device="cpu")


def test_sound_toy_run_is_correct(root):
    res = _toy(root, trace=True)
    assert set(res["checks"]) == set(
        json.loads((ROOT / "benchmark" / "cells" / f"{CELL}.json")
                   .read_text())["limits"])
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["pba.stack_ms"]["value"] > 0


def test_solve_returning_its_start_is_caught(root, monkeypatch):
    from photometric_bundle_adjustment_tpu_torch.optim import ba

    real = ba.lm_fused_cost

    def frozen(problem, *a):
        return real(problem, *a[:-1], a[-1]._replace(max_iterations=0))

    monkeypatch.setattr(ba, "lm_fused_cost", frozen)
    res = _toy(root)
    assert res["correct"] is False, res["checks"]


def test_f32_tier_in_the_programs_place_fails():
    """The float32 tier's answer to a toy request, judged as a run judges
    the program's, fails the cell's limits; the bf16 tier's passes."""
    bf16, _, cell = _drivers()
    limits = cell.settings["limits"]
    req = scenes.make_scene(TOY_TRAFFIC, 2 ** 33 + 17).request(1)
    ref = bf16.reference(req)
    got = {}
    for name, answer in (("bf16", bf16.call), ("f32", bf16.f32_tier)):
        out = answer(req)
        got[name] = bench.aggregate([bf16.compare(out, out["cost"], ref)],
                                    limits)
    assert all(got["bf16"][k] <= lim for k, lim in limits.items()), got
    assert any(got["f32"][k] > lim for k, lim in limits.items()), got
