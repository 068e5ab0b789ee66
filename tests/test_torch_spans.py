"""The port's spans (``utils/spans``) on the CPU, under a CPU
``torch.profiler`` session: which spans the refinement and the geometric
solve record, how often and nested how, that the span counts equal the
solvers' own counters, that the per-level seconds are the spans', that
without a session a span enters no profiler range and syncs nothing, and
that a span is a host range, not a user annotation."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from photometric_bundle_adjustment_tpu_torch import profile_solve
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba, synthetic
from photometric_bundle_adjustment_tpu_torch.optim import ba
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
from photometric_bundle_adjustment_tpu_torch.utils import spans

torch.set_num_threads(1)

LEVELS = 3
ONCE = ("pba.problem", "pba.problem.images", "pba.problem.obs",
        "pba.pyramid", "pba.writeback")
PER_LEVEL = ("pba.level.problem", "pba.level.plan", "pba.level.solve")
# span -> the span it lies in
PARENT = {"pba.problem.images": "pba.problem",
          "pba.problem.obs": "pba.problem",
          "lm.build": "pba.level.solve", "lm.damped": "pba.level.solve",
          "lm.accept": "pba.level.solve"}


def _spans(prof) -> list:
    """The program's spans as (name, start_us, end_us), host side."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith(spans.PREFIXES)]


def _count(recorded, name) -> int:
    return sum(1 for n, _, _ in recorded if n == name)


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def refined():
    pipe = synthetic.synth_pba_pipe(K=12, L=144, H=64, W=96, obs_per_lm=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pba_refine.refine_photometric(pipe, levels=LEVELS, device="cpu",
                                      log=lambda *a: None)
    return pipe.photometric_levels, _spans(prof)


def test_refinement_records_each_span(refined):
    levels, recorded = refined
    assert len(levels) == LEVELS
    for name in ONCE:
        assert _count(recorded, name) == 1, name
    for name in PER_LEVEL:
        assert _count(recorded, name) == LEVELS, name
    assert _count(recorded, "lm.cost") == 0      # the fused-cost loop


def test_refinement_spans_nest(refined):
    _, recorded = refined
    for child in recorded:
        parent = PARENT.get(child[0])
        if parent is not None:
            outer = [s for s in recorded if s[0] == parent]
            assert sum(_within(child, s) for s in outer) == 1, child
    # the levels run in order, each problem, plan and solve in turn
    order = sorted((s for s in recorded if s[0] in PER_LEVEL + ONCE),
                   key=lambda s: s[1])
    names = [s[0] for s in order]
    assert names == (["pba.problem", "pba.problem.images",
                      "pba.problem.obs", "pba.pyramid"]
                     + list(PER_LEVEL) * LEVELS + ["pba.writeback"])
    for a, b in zip(order, order[1:]):
        if not _within(b, a):
            assert a[2] <= b[1], (a, b)


def test_refinement_counts_match_the_solver(refined):
    levels, recorded = refined
    tries = sum(lv["tries"] for lv in levels)
    assert tries > 0
    assert _count(recorded, "lm.accept") == tries
    assert _count(recorded, "lm.damped") == tries
    assert _count(recorded, "lm.build") == tries + LEVELS


def test_level_seconds_are_the_spans(refined):
    levels, recorded = refined
    plans = sorted((s for s in recorded if s[0] == "pba.level.plan"),
                   key=lambda s: s[1])
    solves = sorted((s for s in recorded if s[0] == "pba.level.solve"),
                    key=lambda s: s[1])
    for lv, plan, solve in zip(levels, plans, solves):
        # the stats' clock is the span's: the same range, read on the host
        # inside the profiler's record
        assert 0 < lv["setup_s"] <= (plan[2] - plan[1]) / 1e6
        assert 0 < lv["solve_s"] <= (solve[2] - solve[1]) / 1e6
        assert lv["solve_s"] > 0.5 * (solve[2] - solve[1]) / 1e6


@pytest.mark.parametrize("use_fused", [True, False])
def test_geometric_solve_spans(use_fused):
    """``bundle_adjustment``'s spans, or with ``use_fused=False`` those of
    the scatter-add reference solver ``make_solver`` called directly: its
    ``lm.*`` spans and no ``geo.*`` span."""
    problem, _, _ = synthetic.synth_ba_problem(K=8, L=96, pixel_noise=0.5,
                                               device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if use_fused:
            _, res = geometric_ba.bundle_adjustment(problem, "pinhole")
        else:
            _, res = geometric_ba.make_solver("pinhole")(problem,
                                                         ba.BAConfig())
    recorded = _spans(prof)
    assert res.tries > 0
    assert _count(recorded, "geo.plan") == (1 if use_fused else 0)
    assert _count(recorded, "geo.solve") == (1 if use_fused else 0)
    assert _count(recorded, "lm.build") == res.builds
    assert _count(recorded, "lm.accept") == res.tries
    assert _count(recorded, "lm.damped") == res.tries
    assert _count(recorded, "lm.cost") == res.residual_passes
    if not use_fused:
        assert not [s for s in recorded if s[0].startswith("geo.")]
        return
    (solve,) = [s for s in recorded if s[0] == "geo.solve"]
    assert all(_within(s, solve) for s in recorded if s[0].startswith("lm."))
    for plan in (s for s in recorded if s[0] == "geo.plan"):
        assert plan[2] <= solve[1]


def test_geometric_problem_span():
    gp, _, _ = synthetic.synth_ba_problem(K=6, L=32, device="cpu")
    o = gp.obs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        geometric_ba.build_problem(
            gp.cam_states, gp.inv_depth, o.anchor_cam, o.target_cam,
            o.landmark, o.aux.uv_target, o.aux.uv_ref, o.aux.intr_ref,
            o.aux.intr_target, o.valid, gp.fixed_cams, device="cpu")
    assert _count(_spans(prof), "geo.problem") == 1


def test_no_session_no_profiler_range_no_sync(monkeypatch):
    """Without a profiler a span neither enters a profiler range nor
    syncs, and still times its block; under a session it enters one."""
    entered = []

    class Recording:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    def no_sync(*a, **k):
        raise AssertionError("a span synced the device")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Recording)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    assert not torch.autograd._profiler_enabled()
    with spans.span("lm.build") as s:
        torch.ones(4).sum()
    assert s.seconds is not None and s.seconds >= 0
    pipe = synthetic.synth_pba_pipe(K=8, L=48, H=48, W=64, obs_per_lm=3)
    pba_refine.refine_photometric(pipe, levels=2, max_iterations=3,
                                  device="cpu", log=lambda *a: None)
    assert entered == []
    assert all(lv["solve_s"] > 0 and lv["setup_s"] > 0
               for lv in pipe.photometric_levels)
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("lm.accept") as s:
            pass
    assert entered == ["lm.accept"] and s.seconds >= 0


def test_span_exits_on_error():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with spans.span("lm.damped") as s:
                raise ValueError("inside")
    assert s.seconds is not None
    assert _count(_spans(prof), "lm.damped") == 1


def test_profile_run_counts_no_annotation():
    """``profile_run``'s operators leave out the program's spans."""
    x = torch.randn(64, 64)

    def work():
        with spans.span("lm.build"):
            (x @ x).sum()
        with spans.span("lm.damped"):
            torch.linalg.cholesky(x @ x.T + 64 * torch.eye(64))

    res = profile_solve.profile_run(work, 2, torch.device("cpu"), top=50)
    assert res["top_self_ms"]
    assert not any(k.startswith(spans.PREFIXES) for k in res["top_self_ms"])
    assert any(k.startswith("aten::") for k in res["top_self_ms"])


def test_span_is_a_host_range():
    """A span is a function-scope range on the host timeline (no user
    annotation, whose device-timeline copy a trace would take for a
    device operation) around the operators launched inside it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("lm.build"):
            torch.ones(8).sum()
    (ev,) = [e for e in prof.events() if e.name == "lm.build"]
    assert not ev.is_user_annotation
    assert ev.device_type == torch.autograd.DeviceType.CPU
    assert spans.is_annotation(ev)
    assert {c.name for c in ev.cpu_children} >= {"aten::ones", "aten::sum"}
