"""The harness's data-driven structure, its result line and its import
rule, on the CPU (the program's plain paths at toy sizes)."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run as bench

torch.set_num_threads(1)

ROOT = bench.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def test_every_cell_resolves_by_name():
    for w in SPEC["workloads"]:
        cell = bench.resolve(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["scene"] in ("room", "synth_ba", "map")
        assert {"trace_requests", "check_requests", "limits"} <= set(
            cell.settings)
        assert hasattr(cell.driver(), "Driver")
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_names_units_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for kind, want in keys.items():
        seen = set()
        for e in SPEC[kind]:
            assert set(e) - {"workloads"} == want, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])
    assert 1 <= SPEC["run_seconds"] <= 51


def _tiny_root(tmp: Path, extra_metric: bool = False) -> Path:
    """A checkout-like root holding the benchmark's code and data and
    tiny cells of both drivers, each added as new files only."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp / "benchmark"
    (b / "traffic" / "room-tiny.json").write_text(json.dumps(
        {"scene": "room", "params": dict(
            K=8, L=40, H=48, W=80, obs_per_lm=3, long_tracks=4, max_track=7,
            model="ds", trans_noise=0.02, rot_noise=0.002, depth_noise=0.03,
            keep=0.95)}))
    (b / "traffic" / "synth-tiny.json").write_text(json.dumps(
        {"scene": "synth_ba", "params": dict(
            model="pinhole", K=8, L=96, obs_per_landmark=4, pixel_noise=0.5,
            pose_noise=0.01, depth_noise=0.03, keep=0.95)}))
    for cell, real in (("pba-tiny", "pba-room164-f32"),
                       ("geo-tiny", "geoba-synth512")):
        s = json.loads((b / "cells" / f"{real}.json").read_text())
        s.update(trace_requests=1, check_requests=1, min_requests=2)
        (b / "cells" / f"{cell}.json").write_text(json.dumps(s))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] += [
        dict(name="pba-tiny", config="euroc-room-pba", traffic="room-tiny",
             chips=1, why="toy"),
        dict(name="geo-tiny", config="sfm-geo-ba", traffic="synth-tiny",
             chips=1, why="toy")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        ws = m.get("workloads")
        if ws is not None:
            ws.append("pba-tiny" if ws[0].startswith("pba") else "geo-tiny")
    if extra_metric:
        (b / "metrics" / "geo.requests.py").write_text(
            "def read(run):\n    return float(len(run.outputs))\n")
        spec["per_layer"].append(dict(
            name="geo.requests", unit="requests", better="higher",
            source="program_counter", layer="geometric LM loop",
            moves="ba_solve_ms", workloads=["geo-tiny"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def test_new_cell_and_metric_are_files_only(tmp_path):
    root = _tiny_root(tmp_path, extra_metric=True)
    cell = bench.resolve("geo-tiny", root)
    assert "geo.requests" in [m["name"] for m in cell.per_layer]
    res = bench.run_cell(cell, 2 ** 35 + 3, 0.3, trace=True, device="cpu")
    assert res["metrics"]["geo.requests"]["value"] >= 1
    assert res["correct"] is True


@pytest.mark.parametrize("name,trace", [("pba-tiny", False),
                                        ("geo-tiny", False),
                                        ("pba-tiny", True)])
def test_result_line(tmp_path, name, trace):
    cell = bench.resolve(name, _tiny_root(tmp_path))
    res = bench.run_cell(cell, 2 ** 34 + 11, 0.2, trace=trace, device="cpu")
    keys = list(res)
    assert keys[:5] == list(REQUIRED)
    assert keys[-1] == "checks"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "readings", "checks"}
    assert ("breakdown" in res) == trace
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert "setup_s" in res["metrics"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split('.')[0]
        if top in ('jax', 'jaxlib', 'flax', 'photometric_bundle_adjustment_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
"""


def _python(code: str, **kw):
    return subprocess.run([sys.executable, "-c", BLOCK + code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, **kw)


def test_import_rule():
    """With JAX and the JAX package blocked, the harness, its drivers and
    the reference import; the reference loads nothing of the program."""
    code = """
import benchmark.reference.photometric, benchmark.reference.geometric
import benchmark.roofline, benchmark.scenes, benchmark.lie
bad = sorted({m.split('.')[0] for m in sys.modules}
             & {'photometric_bundle_adjustment_tpu_torch', 'jax',
                'photometric_bundle_adjustment_tpu'})
assert not bad, bad
from benchmark import run
for w in ('pba-room164-f32', 'geoba-v1map'):
    run.resolve(w).driver().Driver(run.resolve(w).config, 'cpu')
assert not run.loaded_forbidden(), run.loaded_forbidden()
print('ok')
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().endswith("ok")


def test_forbidden_names_compare_whole():
    assert "photometric_bundle_adjustment_tpu_torch" not in bench.FORBIDDEN
    saved = sys.modules.get("jaxlib")
    sys.modules["jaxlib"] = object()
    try:
        assert bench.loaded_forbidden() == ["jaxlib"]
    finally:
        del sys.modules["jaxlib"]
        if saved is not None:
            sys.modules["jaxlib"] = saved


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "geoba-v1map",
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, the
    command fails and prints no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "geoba-v1map",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
