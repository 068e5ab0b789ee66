"""The room's chunk layout (``ops/pba_mega.build_chunk_mega_plan``), built
once a refinement on the problem's device: every pyramid level of
``pipeline/pba_refine.refine_photometric`` has the same observation
graph, so the first level builds the layout and all three solvers are
made on it.  ``CHUNK_PLANS`` counts the builds and ``CHUNK_PLAN_REUSES``
the solvers made on a layout an earlier solver had; the refinement is
bit-equal to one whose every level builds its own plan.

The ``cuda`` cases build the layout on the card against the CPU's and
check that the build reads the device only in its three counted reads:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_room_plan.py
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

from benchmark import scenes
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.optim import schur_plan_torch as st
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

torch.set_num_threads(1)

LEVELS = 3
# the reads of one build: the valid count, the plan's chunk counts, the
# level sizes of its trees
READS = 3


@pytest.fixture(scope="module")
def pipe():
    return scenes.room_pipe(K=12, L=120, H=96, W=128, obs_per_lm=5,
                            long_tracks=8, max_track=40, seed=3)


@pytest.fixture(scope="module")
def problem(pipe):
    prob, *_ = pba_refine.build_photometric_problem(pipe, device="cpu")
    return prob


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_layouts_equal(a, b):
    (pa, ra), (pb, rb) = a, b
    assert torch.equal(ra.cpu(), rb.cpu())
    la, lb = pytree.tree_leaves(pa), pytree.tree_leaves(pb)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype == torch.int64
        assert torch.equal(x.cpu(), y.cpu())


def _refine(pipe, sample_bf16, per_level_plans=False, monkeypatch=None):
    """A three-level refinement of a copy of ``pipe`` and the counters'
    growth; with ``per_level_plans`` every level's solver builds its own
    plan (``make_mega_solver`` without a layout)."""
    p = copy.deepcopy(pipe)
    if per_level_plans:
        make = pba_mega.make_mega_solver

        def own_plan(*args, layout=None, **kwargs):
            return make(*args, **kwargs)

        monkeypatch.setattr(pba_mega, "make_mega_solver", own_plan)
    plans, reuses = pba_mega.CHUNK_PLANS, pba_mega.CHUNK_PLAN_REUSES
    pba_refine.refine_photometric(p, max_iterations=4, levels=LEVELS,
                                  sample_bf16=sample_bf16, device="cpu",
                                  log=lambda *a: None)
    return (p, pba_mega.CHUNK_PLANS - plans,
            pba_mega.CHUNK_PLAN_REUSES - reuses)


@pytest.mark.parametrize("sample_bf16", [False, True], ids=["f32", "bf16"])
def test_refinement_builds_one_layout(pipe, sample_bf16, monkeypatch):
    """One build and two reuses a refinement; poses, affine values, depths
    and every level's costs bit-equal to per-level plans."""
    a, plans, reuses = _refine(pipe, sample_bf16)
    assert (plans, reuses) == (1, 2)
    b, plans_b, reuses_b = _refine(pipe, sample_bf16, True, monkeypatch)
    assert (plans_b, reuses_b) == (1 + LEVELS, 0)
    assert len(a.photometric_levels) == LEVELS
    for f in a.cameras:
        assert np.array_equal(a.cameras[f], b.cameras[f])
        assert np.array_equal(a.photometric_affine[f],
                              b.photometric_affine[f])
    assert all(a.landmarks[t].inv_depth == b.landmarks[t].inv_depth
               for t in a.landmarks)
    for la, lb in zip(a.photometric_levels, b.photometric_levels):
        for key in ("level", "initial_cost", "cost", "iterations", "tries"):
            assert la[key] == lb[key], key
    assert a.photometric_levels[-1]["cost"] < a.photometric_levels[0][
        "initial_cost"]


def test_levels_share_one_layout(pipe, problem):
    """The premise: every level's problem has the layout of the
    full-resolution one."""
    flat = pba_refine.build_photometric_problem(pipe, device="cpu")[1]
    H, W = next(iter(pipe.images.values())).shape
    pyramid = pba.build_pyramid(flat.reshape(-1, H, W), LEVELS)
    ref = pba_mega.build_chunk_mega_plan(problem)
    for level in range(LEVELS):
        prob_l = pba_refine.level_problem(problem, pyramid, level)
        _assert_layouts_equal(pba_mega.build_chunk_mega_plan(prob_l), ref)


def test_solver_on_a_layout_builds_no_plan(pipe, problem):
    """A solver made on a layout builds none and uses its plan and rows;
    the first solver on a fresh layout is no reuse, each later one is."""
    flat = pba_refine.build_photometric_problem(pipe, device="cpu")[1]
    H, W = next(iter(pipe.images.values())).shape
    layout = pba_mega.build_chunk_mega_plan(problem)
    plans, reuses = pba_mega.CHUNK_PLANS, pba_mega.CHUNK_PLAN_REUSES
    solvers = [pba_mega.make_mega_solver("ds", flat, H, W, problem,
                                         layout=layout, device="cpu")
               for _ in range(3)]
    assert pba_mega.CHUNK_PLANS == plans
    assert pba_mega.CHUNK_PLAN_REUSES == reuses + 2
    assert layout.solvers == 3
    own = pba_mega.make_mega_solver("ds", flat, H, W, problem, device="cpu")
    assert pba_mega.CHUNK_PLANS == plans + 1
    assert pba_mega.CHUNK_PLAN_REUSES == reuses + 2
    _assert_layouts_equal(own.layout, layout)
    for s in solvers:
        assert s.layout is layout
        # the layout's own tensors: no copy
        assert all(x is y for x, y in zip(pytree.tree_leaves(s.plan),
                                          pytree.tree_leaves(layout.plan)))
        assert torch.equal(s.consts.cols, own.consts.cols)
    cfg = ba.BAConfig(max_iterations=1, huber_delta=9.0)
    cost, neq = solvers[0].build(problem, cfg)
    cost_own, neq_own = own.build(problem, cfg)
    assert torch.equal(cost, cost_own)
    for x, y in zip(neq, neq_own):
        assert torch.equal(x, y)
    prob_d, plan_d = fused.densify_problem(problem, pow2_buckets=False)
    with pytest.raises(ValueError, match="pass one"):
        pba_mega.make_mega_solver("ds", flat, H, W, prob_d, plan_d,
                                  layout=layout, device="cpu")


@pytest.mark.cuda
def test_card_layout_equals_cpu(problem, cuda):
    card = pba_mega.build_chunk_mega_plan(ba.problem_to(problem, cuda))
    assert card.rows.device.type == "cuda"
    assert all(x.device.type == "cuda" for x in pytree.tree_leaves(card.plan))
    _assert_layouts_equal(card, pba_mega.build_chunk_mega_plan(problem))


@pytest.mark.cuda
def test_card_layout_syncs_only_in_its_reads(problem, cuda, monkeypatch):
    """On the card the build syncs only inside ``schur_plan_torch._read``
    (the sync debug mode raises on any other sync, a pageable copy up
    included), copies nothing up, and copies down once a read."""
    prob = ba.problem_to(problem, cuda)
    pba_mega.build_chunk_mega_plan(prob)
    torch.cuda.synchronize()
    read = st._read

    def allowed(values):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(values)
        finally:
            torch.cuda.set_sync_debug_mode(2)

    monkeypatch.setattr(st, "_read", allowed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode(2)
        try:
            pba_mega.build_chunk_mega_plan(prob)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    reads = names.count(st.SYNC_SPAN)
    assert reads == READS
    assert not [n for n in names if "HtoD" in n]
    assert sum("DtoH" in n for n in names) == reads
