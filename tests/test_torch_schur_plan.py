"""The device plan builders (``optim/schur_plan_torch``) against the numpy
builders of ``optim/schur_plan``: every leaf equal in value, shape and
int64 dtype, on random graphs and on the edges (invalid rows, landmarks
with no valid observation, ids that need no tree level, a row of more
than B^2 values, ``pow2_buckets`` on and off, the landmark sort made
by the builder or given to it).  A
geometric solve on a torch-built plan equals one on a numpy-built plan
bit for bit, on both of ``_accel_plan``'s branches; ``_accel_plan`` reads
to the host only in its few ``geo.plan.sync`` spans.

The builders run on CPU tensors here; the ``cuda`` cases run them on the
card (and check that the device plan syncs nowhere else and copies
nothing up) and skip where there is none:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_schur_plan.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from photometric_bundle_adjustment_tpu_torch.models import geometric_ba, synthetic
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.optim import schur_plan as sp
from photometric_bundle_adjustment_tpu_torch.optim import schur_plan_torch as st

torch.set_num_threads(1)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
# the reads of one ``_accel_plan``: the branch test (``sort_tracks``),
# then the dense plan's pair chunks and trees, or the chunk plan's chunk
# counts and trees; the bound leaves room for three more
READS = {"dense": 3, "chunk": 3}
MAX_READS = 6


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def _assert_equal(port, ref, name="plan"):
    """Leaf for leaf: a tuple's fields in turn, an array's dtype (int64 on
    the port's side), shape and values."""
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref), name
        fields = getattr(ref, "_fields", range(len(ref)))
        for f, a, b in zip(fields, port, ref):
            _assert_equal(a, b, f"{name}.{f}")
        return
    assert torch.is_tensor(port) and port.dtype == torch.int64, name
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape, name
    np.testing.assert_array_equal(port.cpu().numpy(), ref, err_msg=name)


def _tree_ids(kind, rng):
    """(ids, n_out, B) of a segment-tree case."""
    if kind == "random":
        return rng.integers(0, 40, 600), 40, 16
    if kind == "dropped":        # ids outside [0, n_out) are dropped
        return rng.integers(-5, 45, 600), 40, 8
    if kind == "unique":         # no row twice: no level
        return rng.permutation(50)[:30], 50, 16
    if kind == "heavy":          # a row of more than B^2 values: 3 levels
        ids = np.r_[np.zeros(300, np.int64), rng.integers(0, 12, 200)]
        return rng.permutation(ids), 12, 4
    if kind == "empty":
        return np.zeros(0, np.int64), 7, 16
    return np.full(5, -1), 4, 16  # nothing kept


def _graph(kind, rng, K=9, L=70, O=600):
    """(anchor_cam, target_cam, landmark, valid, K, L) of an observation
    graph: random tracks, or heavy-tailed ones, or with invalid rows and
    landmarks left with no valid observation."""
    an = rng.integers(0, K, O)
    tn = rng.integers(0, K, O)
    ln = rng.integers(0, L, O)
    valid = None
    if kind == "heavy":
        ln = np.minimum(rng.geometric(0.08, O), L) - 1
    if kind in ("invalid", "no_obs"):
        valid = rng.random(O) > 0.3
    if kind == "no_obs":
        valid &= ln % 5 != 0
    return an, tn, ln, valid, K, L


def _t(x, device):
    return None if x is None else torch.as_tensor(x, device=device)


@pytest.mark.parametrize("kind", ["random", "dropped", "unique", "heavy",
                                  "empty", "none_kept"])
def test_segment_tree_equals_numpy(kind, device):
    ids, n_out, B = _tree_ids(kind, np.random.default_rng(1))
    ref = sp.build_segment_tree(ids, n_out, B)
    if kind == "unique":
        assert len(ref.levels) == 0
    if kind == "heavy":
        assert len(ref.levels) >= 3
    _assert_equal(st.build_segment_tree(_t(ids, device), n_out, B), ref)


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("n", [0, 1, 500])
def test_chunk_segments_equals_numpy(n, B, device):
    ids = np.random.default_rng(n + B).integers(0, 25, n)
    _assert_equal(st._chunk_segments(_t(ids, device), B),
                  sp._chunk_segments(ids, B))


@pytest.mark.parametrize("kind", ["random", "heavy", "no_obs"])
def test_lift_segment_tree_equals_numpy(kind, device):
    an, tn, ln, valid, K, L = _graph(kind, np.random.default_rng(2))
    _, dense = sp.build_dense_lm_plan(an, tn, ln, K, L, valid)
    _assert_equal(st.lift_segment_tree(_t(dense.lm_cam, device),
                                       _t(dense.anchor_cam_of_lm, device), K),
                  sp.lift_segment_tree(dense.lm_cam, dense.anchor_cam_of_lm,
                                       K))


@pytest.mark.parametrize("pow2", [True, False])
@pytest.mark.parametrize("kind", ["random", "heavy", "invalid", "no_obs"])
def test_schur_plan_equals_numpy(kind, pow2, device):
    an, tn, ln, valid, K, L = _graph(kind, np.random.default_rng(3))
    kw = dict(pair_chunk=8, lm_chunk=4, cam_chunk=32, nc_bucket=16,
              pow2_buckets=pow2)
    _assert_equal(st.build_schur_plan(_t(an, device), _t(tn, device),
                                      _t(ln, device), K, L,
                                      _t(valid, device), **kw),
                  sp.build_schur_plan(an, tn, ln, K, L, valid, **kw))
    tracks = st.sort_tracks(_t(ln, device), _t(valid, device), L)
    _assert_equal(st.build_schur_plan(_t(an, device), _t(tn, device),
                                      _t(ln, device), K, L, _t(valid, device),
                                      tracks=tracks),
                  sp.build_schur_plan(an, tn, ln, K, L, valid))


@pytest.mark.parametrize("tracks", [None, "given"])
@pytest.mark.parametrize("pow2", [True, False])
@pytest.mark.parametrize("kind", ["random", "heavy", "invalid", "no_obs"])
def test_dense_lm_plan_equals_numpy(kind, pow2, tracks, device):
    """Built from the graph alone, or from its ``sort_tracks``."""
    an, tn, ln, valid, K, L = _graph(kind, np.random.default_rng(4))
    if tracks == "given":
        tracks = st.sort_tracks(_t(ln, device), _t(valid, device), L)
    kw = dict(pair_chunk=8, nc_bucket=16, pow2_buckets=pow2)
    perm, plan = st.build_dense_lm_plan(_t(an, device), _t(tn, device),
                                        _t(ln, device), K, L,
                                        _t(valid, device), tracks=tracks,
                                        **kw)
    perm_np, plan_np = sp.build_dense_lm_plan(an, tn, ln, K, L, valid, **kw)
    _assert_equal(perm, perm_np, "perm")
    _assert_equal(plan, plan_np)


@pytest.mark.parametrize("kind", ["random", "heavy", "invalid", "no_obs"])
def test_sort_tracks_equals_numpy(kind, device):
    """The valid observations, the longest track, each landmark's count and
    first position in the landmark order, and that order: numpy's stable
    argsort of the valid rows' landmarks."""
    an, _, ln, valid, _, L = _graph(kind, np.random.default_rng(6))
    vm = np.ones(an.size, bool) if valid is None else valid
    counts = np.bincount(ln[vm], minlength=L)
    got = st.sort_tracks(_t(ln, device), _t(valid, device), L)
    assert (got.n_valid, got.longest) == (int(vm.sum()), int(counts.max()))
    _assert_equal(got.counts, counts, "counts")
    _assert_equal(got.starts, np.cumsum(counts) - counts, "starts")
    rows = np.flatnonzero(vm)
    _assert_equal(got.sort[1][:got.n_valid],
                  rows[np.argsort(ln[rows], kind="stable")], "order")


def _problem(branch, device="cpu", K=8, L=96):
    """A float64 geometric problem whose ``_accel_plan`` takes ``branch``:
    uniform tracks are dense; cutting most landmarks to one observation
    (valid=0 rows) makes S_max * L > 3 x the valid rows, the chunk
    branch."""
    problem, _, _ = synthetic.synth_ba_problem(K=K, L=L, obs_per_landmark=4,
                                               pixel_noise=0.5, seed=3,
                                               device=device)
    if branch == "chunk":
        o = problem.obs
        slot = torch.arange(o.valid.shape[0], device=device) // L
        cut = (o.landmark >= 4) & (slot > 0)
        problem = problem._replace(obs=o._replace(
            valid=torch.where(cut, 0.0, o.valid)))
    return problem


def _numpy_builders(monkeypatch):
    """Route the device builders to the numpy ones, on the host (the
    landmark sort they are given goes unused)."""

    def host(build):
        def run(*args, tracks=None, **kwargs):
            args = [a.cpu().numpy() if torch.is_tensor(a) else a
                    for a in args]
            kwargs = {k: v.cpu().numpy() if torch.is_tensor(v) else v
                      for k, v in kwargs.items()}
            return fused.plan_to(build(*args, **kwargs), "cpu")
        return run

    monkeypatch.setattr(st, "build_schur_plan", host(sp.build_schur_plan))
    monkeypatch.setattr(st, "build_dense_lm_plan",
                        host(sp.build_dense_lm_plan))


@pytest.mark.parametrize("branch", ["dense", "chunk"])
def test_solve_on_device_plan_equals_numpy_plan(branch, monkeypatch):
    """The same plan, so the same arithmetic: cost, poses, inverse depths
    and tries bit-equal."""
    problem = _problem(branch)
    _, plan = geometric_ba._accel_plan(problem)
    assert isinstance(plan, sp.DenseLmSchurPlan) == (branch == "dense")
    cfg = ba.BAConfig(max_iterations=6)
    got_p, got = geometric_ba.bundle_adjustment(problem, "pinhole", cfg)
    with monkeypatch.context() as m:
        _numpy_builders(m)
        ref_p, ref = geometric_ba.bundle_adjustment(problem, "pinhole", cfg)
    assert got.tries == ref.tries and got.iterations == ref.iterations
    assert torch.equal(got.cost, ref.cost)
    assert torch.equal(got_p.cam_states, ref_p.cam_states)
    assert torch.equal(got_p.inv_depth, ref_p.inv_depth)
    for name in ("anchor_cam", "target_cam", "landmark", "valid"):
        assert torch.equal(getattr(got_p.obs, name),
                           getattr(ref_p.obs, name)), name
    for a, b in zip(got_p.obs.aux, ref_p.obs.aux):
        assert torch.equal(a, b)


def _sync_spans(problem):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        geometric_ba._accel_plan(problem)
    return [e for e in prof.events() if e.name == st.SYNC_SPAN
            and e.device_type == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("branch", ["dense", "chunk"])
def test_plan_reads_are_few(branch):
    """One ``_accel_plan`` reads to the host in ``READS[branch]``
    ``geo.plan.sync`` spans, whatever the problem's size, under
    ``MAX_READS``."""
    for L in (96, 480):
        reads = _sync_spans(_problem(branch, L=L))
        assert len(reads) == READS[branch] <= MAX_READS, L


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["dense", "chunk"])
def test_device_plan_syncs_only_in_its_reads(branch, monkeypatch):
    """On the card ``_accel_plan`` builds the CPU's plan, syncs only inside
    ``_read`` (the sync debug mode raises on any other sync, a pageable
    copy up included), copies nothing up, and copies down once a read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = _problem(branch, device="cuda")
    _, plan = geometric_ba._accel_plan(problem)
    _, ref = geometric_ba._accel_plan(ba.problem_to(problem, "cpu"))
    _assert_equal(fused.plan_to(plan, "cpu"), ref)
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
            geometric_ba._accel_plan(problem)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    reads = names.count(st.SYNC_SPAN)
    assert reads == READS[branch]
    assert not [n for n in names if "HtoD" in n]
    assert sum("DtoH" in n for n in names) == reads
