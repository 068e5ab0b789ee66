"""The control of every cell comes out not correct, on the card.

For three seeds of each cell, at the cell's own size, on as many of its
first requests as a run checks: the program's answers pass the cell's
limits, and the control's answers to the same requests (the driver's
``control``: the precision below the one the configuration states) fail
at least one of them.  Run on the card:

    python3 -m pytest -q -p no:cacheprovider -m cuda \\
        benchmark/tests/test_perfbench_control.py
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run as bench, scenes

SPEC = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run on the card only")
    return torch.device("cuda:0")


def _fails(worst: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not worst.get(k, 0.0) <= lim]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_program_passes(device, cell_name):
    cell = bench.resolve(cell_name)
    limits = cell.settings["limits"]
    assert limits, "the cell compares no number"
    driver = cell.driver().Driver(cell.config, device)
    for seed in SEEDS:
        scene = scenes.make_scene(cell.traffic, seed, device=device)
        program, control = [], []
        for i in range(1, cell.settings["check_requests"] + 1):
            ref = driver.reference(scene.request(i))
            out = driver.call(scene.request(i))
            program.append(driver.compare(out, out["cost"], ref))
            c = driver.control(scene.request(i))
            control.append(driver.compare(c, c["cost"], ref))
        program = bench.aggregate(program, limits)
        control = bench.aggregate(control, limits)
        assert not _fails(program, limits), (seed, program)
        assert _fails(control, limits), (seed, control)
