"""The bf16-sampling refinement (``apps/pba --sample-bf16``) against its
float64 reference, ``benchmark/reference/photometric_bf16.py``, on a toy
room on the CPU: the reference's rows, the program's answer held to it,
the float32 tier's answer told apart from it, and the level's bf16 cast
made once in the level's plan under ``pba.level.stack``."""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import scenes
from benchmark.drivers import photometric_refine as f32_driver
from benchmark.reference import photometric, photometric_bf16
from photometric_bundle_adjustment_tpu_torch.apps import pba
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.optim import ba
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
from photometric_bundle_adjustment_tpu_torch.utils import spans

torch.set_num_threads(1)

# benchmark/tests/test_perfbench_faults.py's toy room
TOY = dict(K=12, L=300, H=96, W=128, obs_per_lm=5, long_tracks=20,
           max_track=10, model="ds", seed=3)
LEVELS, ITERATIONS, HUBER = 3, 20, 9.0


def _refine(pipe, sample_bf16: bool) -> dict:
    """The program's answer on a copy of ``pipe``, in the form the
    benchmark's driver returns."""
    pipe = copy.deepcopy(pipe)
    levels = pba.refine_map(pipe, iterations=ITERATIONS, huber=HUBER,
                            levels=LEVELS, sample_bf16=sample_bf16,
                            log=lambda *a: None, device="cpu")
    out = f32_driver._solution(pipe, sorted(pipe.cameras),
                               sorted(pipe.landmarks))
    out.update(cost=float(levels[-1]["cost"]), levels=levels)
    return out


@pytest.fixture(scope="module")
def room():
    pipe = scenes.room_pipe(**TOY)
    ref = photometric_bf16.refine(pipe, torch.device("cpu"), torch.float64,
                                  levels=LEVELS, iterations=ITERATIONS)
    return pipe, ref


def test_reference_rows_round_only_the_coarse_targets(room):
    pipe, _ = room
    cpu = torch.device("cpu")
    p32 = photometric.MapProblem(pipe, cpu, torch.float64)
    p16 = photometric_bf16.MapProblem(pipe, cpu, torch.float64)
    pyr = photometric.pyramid(p32.images, LEVELS)
    for level in range(LEVELS):
        a = p32.level_rows(pyr[level], level)
        b = p16.level_rows(pyr[level], level)
        rounded = pyr[level].to(torch.bfloat16).to(torch.float64)
        # the patches are sampled from the unrounded level
        assert torch.equal(a.const["patch"], b.const["patch"])
        assert torch.equal(b.const["images"], rounded)
        if level == 0:
            # 8-bit intensities are exact in bf16: level 0 is unchanged
            assert torch.equal(a.const["images"], b.const["images"])
        else:
            # averaged levels hold quarters and sixteenths, which bf16
            # (8 significant bits) rounds from 64 and from 16 up
            assert not torch.equal(a.const["images"], b.const["images"])
    assert photometric_bf16.cost_at is photometric.cost_at


def test_bf16_tier_matches_its_reference(room):
    pipe, ref = room
    got = f32_driver.compare(_refine(pipe, True), 0.0, ref)
    # The program solves in f32 and the reference in f64, both 20
    # iterations a level from the same start; on the card the f32 cell's
    # sound runs read up to 8.7e-5 (cost_rel) and 1.7e-5 (median of the
    # landmarks' inverse-depth gaps), and its limits are 1e-3 and 5e-5.
    assert got["cost_rel"] <= 1e-4, got
    assert got["rho_rel_median"] <= 5e-5, got
    # each level's final cost is the reference's to f32's rounding of a
    # sum over the level's residuals
    assert got["level_cost_rel"] <= 1e-4, got


def test_f32_tier_is_told_apart(room):
    """The float32 tier's coarse levels minimise another cost, so its
    levels' final costs lie far from the bf16 reference's."""
    pipe, ref = room
    bf16 = f32_driver.compare(_refine(pipe, True), 0.0, ref)
    f32 = f32_driver.compare(_refine(pipe, False), 0.0, ref)
    assert f32["level_cost_rel"] > 100.0 * bf16["level_cost_rel"], (
        f32, bf16)
    assert f32["level_cost_rel"] > 1e-2, f32


def _refine_counted(sample_bf16: bool):
    pipe = synthetic.synth_pba_pipe(K=8, L=48, H=48, W=64, obs_per_lm=3)
    casts, nbytes = pba_mega.STACK_CASTS, pba_mega.STACK_CAST_BYTES
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pba_refine.refine_photometric(pipe, levels=LEVELS, max_iterations=3,
                                      sample_bf16=sample_bf16, device="cpu",
                                      log=lambda *a: None)
    recorded = [(e.name, e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(spans.PREFIXES)]
    return (pipe, recorded, pba_mega.STACK_CASTS - casts,
            pba_mega.STACK_CAST_BYTES - nbytes)


def _inside(name, outer, recorded) -> int:
    """How many spans ``name`` lie inside a span ``outer``."""
    outers = [(s, e) for n, s, e in recorded if n == outer]
    return sum(any(os_ <= s and e <= oe for os_, oe in outers)
               for n, s, e in recorded if n == name)


def test_bf16_cast_once_a_level_in_the_plan():
    pipe, recorded, casts, nbytes = _refine_counted(True)
    levels = pipe.photometric_levels
    assert casts == LEVELS
    assert nbytes == sum(2 * len(pipe.cameras) * lv["H"] * lv["W"]
                         for lv in levels)
    stacks = sorted((s, e) for n, s, e in recorded if n == "pba.level.stack")
    assert len(stacks) == LEVELS
    assert _inside("pba.level.stack", "pba.level.plan", recorded) == LEVELS
    assert _inside("pba.level.stack", "pba.level.solve", recorded) == 0
    for lv, (s, e) in zip(levels, stacks):
        assert 0 < lv["stack_s"] <= (e - s) / 1e6
        assert lv["stack_s"] < lv["setup_s"]


def test_f32_tier_casts_nothing():
    pipe, recorded, casts, nbytes = _refine_counted(False)
    assert casts == 0 and nbytes == 0
    assert not any(n == "pba.level.stack" for n, _, _ in recorded)
    assert [lv["stack_s"] for lv in pipe.photometric_levels] == [0.0] * 3


def test_early_cast_leaves_the_answer_bit_equal():
    """The level's cast made in the plan is the one a first build would
    make: a level solved from a solver whose stack was cast first equals
    one whose first build casts it."""
    pipe = synthetic.synth_pba_pipe(K=8, L=48, H=48, W=64, obs_per_lm=3)
    problem, flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe, device="cpu")
    cfg = ba.BAConfig(max_iterations=3, huber_delta=HUBER, sample_bf16=True)
    answers = []
    for early in (True, False):
        solve = pba_mega.make_mega_solver("ds", flat, H, W, problem,
                                          device="cpu")
        if early:
            solve.stack(cfg)
        solved, res = solve(problem, cfg)
        answers.append((solved.cam_states.pose, solved.inv_depth,
                        float(res.cost)))
    (p0, r0, c0), (p1, r1, c1) = answers
    assert torch.equal(p0, p1) and torch.equal(r0, r1) and c0 == c1
    assert np.isfinite(c0)
