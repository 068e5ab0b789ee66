"""The plan builders of ``optim/schur_plan`` in torch integer operations,
on the device of their inputs.

``build_schur_plan``, ``build_dense_lm_plan``, ``build_segment_tree``,
``lift_segment_tree`` and ``_chunk_segments`` return what their namesakes
in ``optim/schur_plan`` return, array for array, as int64 tensors on the
inputs' device: the same plans, built where the solve runs, with no copy
of the observation graph to the host and none of the plan back.  Every
intermediate is an integer and every order comes from a stable sort, so
a plan is exact and repeats bit for bit.  A scatter writes positions that
are unique; numpy's ``flatnonzero`` of a mask whose count is known
becomes a binary search in the mask's prefix sum; a run of equal sorted
keys is found by binary search too.

The sizes that depend on the data (the chunk counts, the slots a landmark
needs, the sizes of a segment tree's levels) are read to the host a batch
at a time, each read a ``geo.plan.sync`` span (``utils/spans``), so that
a trace counts how often a plan waits for the device and for how long.
``sort_tracks`` sorts the observations by landmark and reads the valid
count and the longest track in one read; both plan builders take that sort
rather than sort again.  After it a ``build_schur_plan`` reads twice (its
four chunk counts, then the level sizes of its four trees), a
``build_dense_lm_plan`` twice (the pair chunks, its three trees).  A
tree's level sizes follow from its rows' counts alone (a row of c values
has ceil(c / B^j) at level j), so one read gives every level.

The numpy builders stay: tests hold these against them, and
``parallel/dist_fused.prepare`` still builds on the host.
``ops/pba_mega.build_chunk_mega_plan`` builds the room's plan here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    ChunkPlan,
    DenseLmSchurPlan,
    SchurPlan,
    SegmentTree,
    _round_up,
)
from photometric_bundle_adjustment_tpu_torch.utils.spans import span

SYNC_SPAN = "geo.plan.sync"
# the sort key of an entry left out: after every real key
_LAST = torch.iinfo(torch.int64).max


def _read(values: list) -> list:
    """The host ints of int64 tensors (0-d or 1-d), in one read."""
    with span(SYNC_SPAN):
        return torch.cat([v.reshape(-1) for v in values]).tolist()


def _long(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long().reshape(-1)


def _mask(valid, n: int, device) -> torch.Tensor:
    if valid is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return torch.as_tensor(valid, device=device).reshape(-1).bool()


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _compact(mask: torch.Tensor, n: int) -> torch.Tensor:
    """``flatnonzero(mask)`` of a mask with n entries set: the k-th set
    entry is where the mask's prefix sum first reaches k."""
    return torch.searchsorted(torch.cumsum(mask, 0),
                              _arange(n, mask.device) + 1)


def _pad_rows(x: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    """x with rows of ``fill`` appended up to n rows."""
    return torch.cat([x, x.new_full((n - x.shape[0],) + tuple(x.shape[1:]),
                                    fill)])


def _sort(keys: torch.Tensor, ok: torch.Tensor):
    """Stable sort of ``keys[ok]``, the others after them: (sorted keys,
    order, position of each sorted entry within its run of equal keys)."""
    sk, order = torch.sort(torch.where(ok, keys, _LAST), stable=True)
    in_run = _arange(sk.numel(), sk.device) - torch.searchsorted(sk, sk)
    return sk, order, in_run


def _chunk_table(sk, order, in_run, sel, nc: int, B: int):
    """The chunks of the sorted entries at positions ``sel`` (ascending,
    whole runs): ``(gidx (nc, B), rows (nc,))`` as ``_chunk_segments``
    gives them, -1 padding, entries named by ``order``."""
    s = in_run[sel] % B
    chunk = torch.cumsum(s == 0, 0) - 1
    loc = torch.full((nc * B,), -1, dtype=torch.int64, device=sk.device)
    loc = loc.scatter_(0, chunk * B + s, sel).view(nc, B)
    gidx = torch.where(loc >= 0, order[loc.clamp(min=0)], -1)
    return gidx, sk[loc[:, 0]]


def _chunk_prep(keys, ok, B: int, sort=None):
    """The sort for the chunks of ``keys[ok]`` (``sort``, if already made),
    and the two counts to read before they are built: the entries, the
    chunks."""
    sk, order, in_run = _sort(keys, ok) if sort is None else sort
    live = ok[order]
    return (sk, order, in_run), [live.sum(), (live & (in_run % B == 0)).sum()]


def _chunk_finish(prep, n: int, nc: int, B: int):
    sk, order, in_run = prep
    return _chunk_table(sk, order, in_run, _arange(n, sk.device), nc, B)


def _chunk_segments(ids, B: int):
    """``schur_plan._chunk_segments``: ``(gather_order (NC, B) with -1
    padding, row_ids (NC,))``, the chunks of <= B entries of one row each,
    by a stable sort of ``ids``."""
    ids = _long(ids)
    prep, counts = _chunk_prep(ids, _mask(None, ids.numel(), ids.device), B)
    return _chunk_finish(prep, *_read(counts), B)


def _levels_bound(n: int, B: int) -> int:
    """The most levels a tree over n values can need."""
    levels = 0
    while n > 1:
        n, levels = -(-n // B), levels + 1
    return levels


def _tree_prep(ids, n_out: int, B: int):
    """The sort of a tree's first level and the counts to read: the values
    kept, then per level the rows of one value, the values of the other
    rows and their chunks.  A row of c values has ceil(c / B^j) at level
    j."""
    ids = _long(ids)
    n = ids.numel()
    sk, order, in_run = _sort(ids, (ids >= 0) & (ids < n_out))
    live = sk != _LAST
    run = torch.searchsorted(sk, sk, right=True) - (_arange(n, sk.device)
                                                    - in_run)
    c = torch.where(live & (in_run == 0), run, 0)      # a row's count, once
    per = B ** _arange(_levels_bound(n, B), sk.device)[:, None]
    c = (c + per - 1) // per                           # (levels, n)
    multi = c > 1
    counts = torch.stack([(c == 1).sum(1), torch.where(multi, c, 0).sum(1),
                          torch.where(multi, (c + B - 1) // B, 0).sum(1)], 1)
    return (ids, sk, order, in_run, run, live), [live.sum(), counts]


def _tree_finish(prep, counts: list, n_out: int, B: int) -> SegmentTree:
    ids, sk, order, in_run, run, live = prep
    dev = ids.device
    rid, n_prev, levels = ids, ids.numel(), []
    for j in range(1, len(counts), 3):
        n1, nm, nc = counts[j:j + 3]
        if nc == 0:
            break
        if levels:      # the rows the last level left, sorted anew
            sk, order, in_run = _sort(rid, _mask(None, n_prev, dev))
            run = (torch.searchsorted(sk, sk, right=True)
                   - (_arange(n_prev, dev) - in_run))
            live = _mask(None, n_prev, dev)
        one = torch.zeros(n_prev, dtype=torch.bool, device=dev)
        single = _compact(one.scatter_(0, order, live & (run == 1)), n1)
        multi, rows = _chunk_table(sk, order, in_run,
                                   _compact(live & (run > 1), nm), nc, B)
        multi = torch.cat([torch.where(multi >= 0, multi, n_prev),
                           multi.new_full((1, B), n_prev)])
        levels.append((single, multi))
        rid = torch.cat([rid[single], rows])
        n_prev = rid.numel()
    pick = torch.full((n_out,), n_prev, dtype=torch.int64, device=dev)
    if levels:
        pick.scatter_(0, rid, _arange(n_prev, dev))
    else:
        pick.scatter_(0, sk[:counts[0]], order[:counts[0]])
    return SegmentTree(levels=tuple(levels), pick=pick)


def _trees(specs, B: int = 16) -> list:
    """The ``SegmentTree`` of each ``(ids, n_out)``, with one read for
    all."""
    preps = [_tree_prep(ids, n_out, B) for ids, n_out in specs]
    got = _read([x for _, counts in preps for x in counts])
    out = []
    for (prep, (_, counts)), (_, n_out) in zip(preps, specs):
        n = 1 + counts.numel()
        out.append(_tree_finish(prep, got[:n], n_out, B))
        got = got[n:]
    return out


def build_segment_tree(ids, n_out: int, B: int = 16) -> SegmentTree:
    """``schur_plan.build_segment_tree``: the tree that sums value row i
    into output row ``ids[i]`` (ids outside [0, n_out) dropped)."""
    return _trees([(ids, n_out)], B)[0]


def _lift_ids(lm_cam, anchor_cam_of_lm, K: int) -> torch.Tensor:
    cams = torch.cat([torch.as_tensor(lm_cam).long(),
                      torch.as_tensor(anchor_cam_of_lm).long()[None]], 0)
    lm = _arange(cams.shape[1], cams.device)
    return torch.where(cams < K, lm * K + cams, -1)


def lift_segment_tree(lm_cam, anchor_cam_of_lm, K: int) -> SegmentTree:
    """``schur_plan.lift_segment_tree``: slot s of landmark l (s = S for
    its anchor) into output row l*K + k of its camera k."""
    ids = _lift_ids(lm_cam, anchor_cam_of_lm, K)
    return build_segment_tree(ids, ids.shape[1] * K)


def _pair_rows4(prows: torch.Tensor, K: int) -> torch.Tensor:
    pa, pc = prows // K, prows % K
    return torch.stack([pa * K + pa, pa * K + pc, pc * K + pa, pc * K + pc],
                       1)


class Tracks(NamedTuple):
    """The observations sorted by landmark (``_sort``: the valid ones by
    landmark, stably, the others after them), each landmark's first
    position in that order and its count; and, read to the host, the valid
    observations and the most of them on one landmark."""
    sort: tuple
    starts: torch.Tensor
    counts: torch.Tensor
    n_valid: int
    longest: int


def sort_tracks(landmark, valid, L: int) -> Tracks:
    """The ``Tracks`` of an observation graph, in one read."""
    ln = _long(landmark)
    ok = _mask(valid, ln.numel(), ln.device)
    sort = _sort(ln, ok)
    lms = _arange(L, ln.device)
    starts = torch.searchsorted(sort[0], lms)
    counts = torch.searchsorted(sort[0], lms, right=True) - starts
    n_valid, longest = _read([ok.sum(),
                              torch.cat([counts, counts.new_zeros(1)]).max()])
    return Tracks(sort, starts, counts, n_valid, longest)


def build_schur_plan(
    anchor_cam,
    target_cam,
    landmark,
    K: int,
    L: int,
    valid=None,
    *,
    pair_chunk: int = 32,
    lm_chunk: int = 8,
    cam_chunk: int = 256,
    nc_bucket: int = 64,
    pow2_buckets: bool = True,
    tracks: Tracks | None = None,
) -> SchurPlan:
    """``schur_plan.build_schur_plan`` on the inputs' device; ``tracks``,
    this graph's ``sort_tracks``, saves the landmark sort."""
    an = _long(anchor_cam)
    dev = an.device
    tn, ln = _long(target_cam, dev), _long(landmark, dev)
    O = an.numel()
    ok = _mask(valid, O, dev)

    def bucket(n):
        return _round_up(n, nc_bucket, pow2_buckets)

    sizes = (pair_chunk, lm_chunk, cam_chunk, cam_chunk)
    sorts = (None, None if tracks is None else tracks.sort, None, None)
    preps = [_chunk_prep(keys, ok, B, sort)
             for keys, B, sort in zip((an * K + tn, ln, an, tn), sizes,
                                      sorts)]
    got = iter(_read([x for _, counts in preps for x in counts]))
    (pg, prows), *rest = [_chunk_finish(prep, next(got), next(got), B)
                          for (prep, _), B in zip(preps, sizes)]

    # camera-pair Gram chunks for H_cc
    ncp = bucket(pg.shape[0])
    pg = _pad_rows(torch.where(pg >= 0, pg, O), ncp, O)
    cc_rows4 = _pad_rows(_pair_rows4(prows, K), ncp, K * K)

    # landmark chunks, then the camera chunks of g_c: (gather, rows) padded
    # to their bucket, dummies gathering the zero row O into row ``drop``
    plans = []
    for (g, r), drop in zip(rest, (L, K, K)):
        nc = bucket(g.shape[0])
        plans.append((_pad_rows(torch.where(g >= 0, g, O), nc, O),
                      _pad_rows(r, nc, drop)))
    trees = _trees([(plans[0][1], L), (plans[1][1], K), (plans[2][1], K),
                    (cc_rows4, K * K)])
    lm_plan, gc_a, gc_t = (ChunkPlan(g, r, tree)
                           for (g, r), tree in zip(plans, trees))

    # the one-hot lift's tables: the target camera of each landmark-chunk
    # slot (K for dummies); the first valid observation's anchor camera of
    # each landmark (K where it has none), from the landmark sort
    lm_cam = torch.where(lm_plan.gidx < O,
                         tn[lm_plan.gidx.clamp(0, O - 1)], K)
    sk, order, _ = preps[1][0]
    lms = _arange(L, dev)
    first = torch.searchsorted(sk, lms).clamp(max=O - 1)
    anchor_cam_of_lm = torch.where(sk[first] == lms, an[order[first]], K)

    return SchurPlan(pg=pg, cc_rows4=cc_rows4, lm=lm_plan, gc_a=gc_a,
                     gc_t=gc_t, lm_cam=lm_cam,
                     anchor_cam_of_lm=anchor_cam_of_lm, cc_seg=trees[3])


def build_dense_lm_plan(
    anchor_cam,
    target_cam,
    landmark,
    K: int,
    L: int,
    valid=None,
    *,
    pair_chunk: int = 32,
    nc_bucket: int = 64,
    pow2_buckets: bool = True,
    tracks: Tracks | None = None,
):
    """``schur_plan.build_dense_lm_plan`` at its default ``slot_bucket``
    (2) and free slot count: ``(perm, plan)``, ``perm`` (S*L,) the
    original row of each slot-major row (-1 for padding).  ``tracks``, this
    graph's ``sort_tracks``, saves its sort and its read."""
    an = _long(anchor_cam)
    dev = an.device
    tn = _long(target_cam, dev)
    if tracks is None:
        tracks = sort_tracks(landmark, valid, L)
    (sk, order, _), starts, counts, n_valid, longest = tracks
    S = _round_up(max(longest, 1), 2, pow2_buckets)

    # slot assignment: stable order within each landmark; slot-major rows
    lv = sk[:n_valid]
    slot = _arange(n_valid, dev) - starts[lv]
    perm = torch.full((S * L,), -1, dtype=torch.int64, device=dev)
    perm.scatter_(0, slot * L + lv, order[:n_valid])
    filled = perm >= 0
    take = torch.where(filled, perm, 0)
    an_d, tn_d = an[take], tn[take]

    # camera-pair Gram chunks over the padded rows
    Opad = L * S
    prep, pcounts = _chunk_prep(an_d * K + tn_d, filled, pair_chunk)
    pg, prows = _chunk_finish(prep, *_read(pcounts), pair_chunk)
    ncp = _round_up(pg.shape[0], nc_bucket, pow2_buckets)
    pg = _pad_rows(torch.where(pg >= 0, pg, Opad), ncp, Opad)
    cc_rows4 = _pad_rows(_pair_rows4(prows, K), ncp, K * K)

    # per-row camera ids for the one-hot g_c matmuls (K masks padding rows)
    obs_anchor_cam = torch.where(filled, an_d, K)
    obs_target_cam = torch.where(filled, tn_d, K)
    lm_cam = obs_target_cam.reshape(S, L)
    anchor_cam_of_lm = torch.where(counts > 0, an_d.reshape(S, L)[0], K)

    cc_seg, gc_seg, m_seg = _trees([
        (cc_rows4, K * K),
        (torch.cat([obs_anchor_cam, obs_target_cam]), K),
        (_lift_ids(lm_cam, anchor_cam_of_lm, K), L * K)])
    return perm, DenseLmSchurPlan(
        pg=pg, cc_rows4=cc_rows4, obs_anchor_cam=obs_anchor_cam,
        obs_target_cam=obs_target_cam, lm_cam=lm_cam,
        anchor_cam_of_lm=anchor_cam_of_lm, cc_seg=cc_seg, gc_seg=gc_seg,
        m_seg=m_seg)
