"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``run.run_cell`` past its look for a
card, on the program's CPU paths) on toy versions of the cells with the
real cells' limits, once sound and once with one fault planted in the
program: a solve that returns its state unchanged, half of the
observations left out, or an answer altered where it is produced.  (The
cells take one card, so there is no exchange between cards to leave
out.)"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run as bench

torch.set_num_threads(1)
ROOT = bench.ROOT

TOY = {
    "pba-toy": ("pba-room164-f32", "euroc-room-pba", {
        "scene": "room", "params": dict(
            K=12, L=300, H=96, W=128, obs_per_lm=5, long_tracks=20,
            max_track=10, model="ds", trans_noise=0.02, rot_noise=0.002,
            depth_noise=0.03, keep=0.95)}),
    "geo-toy": ("geoba-synth512", "sfm-geo-ba", {
        "scene": "synth_ba", "params": dict(
            model="pinhole", K=10, L=160, obs_per_landmark=5,
            pixel_noise=0.5, pose_noise=0.01, depth_noise=0.03, keep=0.95,
            anchor_span=5)}),
    "v1-toy": ("geoba-v1map", "sfm-geo-ba", None),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    tmp = tmp_path_factory.mktemp("toy")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (real, config, traffic) in TOY.items():
        settings = json.loads(
            (ROOT / "benchmark" / "cells" / f"{real}.json").read_text())
        settings.update(check_requests=2 if traffic is not None else 1,
                        min_requests=2)
        (tmp / "benchmark" / "cells" / f"{name}.json").write_text(
            json.dumps(settings))
        w = next(x for x in spec["workloads"] if x["name"] == real)
        if traffic is not None:
            (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(
                json.dumps(traffic))
        spec["workloads"].append(dict(w, name=name, traffic=(
            name if traffic is not None else w["traffic"])))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def _run(root, name) -> dict:
    return bench.run_cell(bench.resolve(name, root), 2 ** 33 + 17, 0.1,
                          trace=False, device="cpu")


def _unchanged(monkeypatch):
    from photometric_bundle_adjustment_tpu_torch.optim import ba

    for loop in ("lm_fused_cost", "lm_classic"):
        real = getattr(ba, loop)

        def frozen(problem, *a, _real=real):
            return _real(problem, *a[:-1], a[-1]._replace(max_iterations=0))

        monkeypatch.setattr(ba, loop, frozen)


def _half_rows(monkeypatch):
    """Every second observation row marked invalid before the solve."""
    from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    def halve(problem):
        v = problem.obs.valid.clone()
        v[1::2] = 0
        return problem._replace(obs=problem.obs._replace(valid=v))

    real_build = pba_refine.build_photometric_problem

    def build(*a, **k):
        problem, *rest = real_build(*a, **k)
        return (halve(problem), *rest)

    monkeypatch.setattr(pba_refine, "build_photometric_problem", build)
    real_plan = geometric_ba._accel_plan
    monkeypatch.setattr(geometric_ba, "_accel_plan",
                        lambda p: real_plan(halve(p)))


def _altered(monkeypatch):
    """One free camera moved 5 cm along x in the returned answer."""
    from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    real_refine = pba_refine.refine_photometric

    def refine(pipe, *a, **k):
        res = real_refine(pipe, *a, **k)
        key = sorted(pipe.cameras)[-1]
        pipe.cameras[key] = pipe.cameras[key] + [0.05, 0, 0, 0, 0, 0, 0]
        return res

    monkeypatch.setattr(pba_refine, "refine_photometric", refine)
    real_ba = geometric_ba.bundle_adjustment

    def solve(problem, *a, **k):
        solved, res = real_ba(problem, *a, **k)
        poses = solved.cam_states.clone()
        poses[-1, 0] += 0.05
        return solved._replace(cam_states=poses), res

    monkeypatch.setattr(geometric_ba, "bundle_adjustment", solve)


@pytest.mark.parametrize("name", list(TOY))
def test_sound_run_is_correct(root, name):
    res = _run(root, name)
    assert res["checks"], "the cell compares no number"
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _altered],
                         ids=["unchanged", "half_rows", "altered"])
@pytest.mark.parametrize("name", list(TOY))
def test_fault_is_caught(root, name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(root, name)
    assert res["correct"] is False, res["checks"]
