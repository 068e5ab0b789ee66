"""``SfmPipeline.match_all`` and ``match_bow`` of the port against the JAX
package's, on the CPU: both pipelines run detection, stereo matching and
all-pairs matching with RANSAC on one rendered stereo sequence (4 frames,
8 images of 240x376, EuRoC's double-sphere rig).

The worklists are identical.  The match lists are identical, apart from
rows where a ratio test sits exactly on its boundary: the JAX package's
CPU path matches with its native C++ matcher, which evaluates the ratio
in double, the port in float32 (ROADMAP Queue 3).  RANSAC draws from
different generators in the two packages (``jax.random`` against a
``torch.Generator``), so the inlier sets are not compared: the pairs that
succeed are the same, and in both packages every relative rotation lies
within 6e-2 rad of the ground truth, their median within 2e-2 rad, and 80%
of the inliers within 2 px of the true correspondence.  The translation
directions are not held: the baselines are 4 to 23 cm against depths of
metres, so the RANSAC threshold (5e-5, about 0.01 rad) spans the whole
parallax, in both packages alike.

The budget is 128 matches a pair: the JAX native path's compaction
raises where the compacted feature count (128 here) is below the budget."""

import copy
import functools

import numpy as np
import torch

from photometric_bundle_adjustment_tpu.features import bow as jbow
from photometric_bundle_adjustment_tpu.pipeline.config import (
    SfmConfig as JSfmConfig,
)
from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
    SfmPipeline as JSfmPipeline,
)
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.features import bow
from photometric_bundle_adjustment_tpu_torch.io import cereal_io
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.pipeline.config import SfmConfig
from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
    SfmPipeline,
)

torch.set_num_threads(1)

MM, GT_PX = 128, 2.0
ROT_MAX, ROT_MEDIAN, GT_SHARE = 6e-2, 2e-2, 0.8
QUIET = dict(log=lambda *a: None)


@functools.cache
def sequence():
    return synthetic.synth_stereo_sequence(n_frames=4, H=240, W=376,
                                           device="cpu")


@functools.cache
def pipelines():
    """(JAX pipeline, port pipeline) after detect_keypoints, match_stereo
    and match_all on the same images, seed 0 each."""
    seq = sequence()
    pj = JSfmPipeline(seq.images, seq.calib,
                      JSfmConfig(max_matches_per_pair=MM), seed=0, **QUIET)
    pt = SfmPipeline(seq.images, seq.calib, SfmConfig(max_matches_per_pair=MM),
                     seed=0, device="cpu", **QUIET)
    for p in (pj, pt):
        p.detect_keypoints()
        p.match_stereo()
        p.match_all()
    return pj, pt


def _ratio_boundary(d1, v1, d2, v2, row, ratio):
    """Whether row ``row`` of descriptors d1 meets the ratio test against
    d2 in double but not in float32, or the reverse."""
    x = np.unpackbits((d1[row][None] ^ d2).view(np.uint8), axis=1).sum(1)
    x = np.sort(np.where(v2, x, 1 << 20))
    best, second = int(x[0]), int(x[1])
    f32 = np.float32(second) >= np.float32(best) * np.float32(ratio)
    return bool(f32 != (second >= best * ratio))


def test_worklist_and_layout_match_jax():
    pj, pt = pipelines()
    ids = pt._pair_worklist()
    assert ids == pj._pair_worklist() and len(ids) == 24
    assert sorted(pt.matches) == sorted(pj.matches) and len(pt.matches) == 28
    for md in pt.matches.values():
        assert md["T_i_j"].shape == (7,) and md["T_i_j"].dtype == np.float64
        assert md["matches"].dtype == md["inliers"].dtype == np.int32
        assert md["matches"].shape[1:] == md["inliers"].shape[1:] == (2,)
    assert pt.counters["match_pairs"] == 24 and pt.counters["match_chunks"] == 1
    assert pt.timings["match_all"] > 0


def test_match_lists_match_jax():
    pj, pt = pipelines()
    ratio = pt.cfg.feature_match_test_next_best
    n_rows = 0
    for key, md in pt.matches.items():
        a, b = key
        got = {int(r): int(c) for r, c in md["matches"]}
        ref = {int(r): int(c) for r, c in np.asarray(pj.matches[key]["matches"])}
        n_rows += len(got)
        ca, cb = pt.corners[a], pt.corners[b]
        for r in set(got.items()) ^ set(ref.items()):
            row, col = r
            assert (_ratio_boundary(ca["desc"], ca["valid"], cb["desc"],
                                    cb["valid"], row, ratio)
                    or _ratio_boundary(cb["desc"], cb["valid"], ca["desc"],
                                       ca["valid"], col, ratio)), (key, r)
    assert n_rows > 1500


def _rotation_errors(matches, seq, keys):
    out = []
    for a, b in keys:
        T_gt = se3.compose(se3.inverse(torch.as_tensor(seq.poses_gt[a])),
                           torch.as_tensor(seq.poses_gt[b]))
        T = torch.as_tensor(np.asarray(matches[(a, b)]["T_i_j"]))
        out.append(float(torch.linalg.norm(se3.so3_log(se3.quat_mul(
            se3.quat_conj(se3.rotation(T)), se3.rotation(T_gt))))))
    return np.array(out)


def test_successful_pairs_and_poses_match_jax():
    pj, pt = pipelines()
    seq = sequence()
    keys = [(pt.fcids[i], pt.fcids[j]) for i, j in pt._pair_worklist()]
    ok_t = {k for k in keys if len(pt.matches[k]["inliers"])}
    ok_j = {k for k in keys if len(pj.matches[k]["inliers"])}
    assert ok_t == ok_j and len(ok_t) >= 20
    for matches in (pt.matches, interop.matches_to_numpy(pj.matches)):
        err = _rotation_errors(matches, seq, sorted(ok_t))
        assert err.max() <= ROT_MAX and np.median(err) <= ROT_MEDIAN, err
        close = total = 0
        for key in ok_t:
            inl = matches[key]["inliers"]
            uv_a = pt.corners[key[0]]["uv"][inl[:, 0]]
            uv_b = pt.corners[key[1]]["uv"][inl[:, 1]]
            uv_t, front = seq.correspondence(key[0], key[1], uv_a)
            close += int(((np.linalg.norm(uv_t - uv_b, axis=1) <= GT_PX)
                          & front).sum())
            total += len(inl)
        assert close >= GT_SHARE * total, (close, total)


def test_match_all_keeps_stereo_and_seeds_reproduce():
    """The stereo matches survive ``match_all``; a second pipeline with
    the same seed draws the same samples, so its results are identical."""
    _, pt = pipelines()
    seq = sequence()
    p2 = SfmPipeline(seq.images, seq.calib, SfmConfig(max_matches_per_pair=MM),
                     seed=0, device="cpu", **QUIET)
    p2.detect_keypoints()
    p2.match_stereo()
    p2.match_all()
    for key, md in pt.matches.items():
        for name in ("T_i_j", "matches", "inliers"):
            np.testing.assert_array_equal(p2.matches[key][name], md[name])
    assert sum(k[0][0] == k[1][0] for k in pt.matches) == 4


def _vocabulary(corners, build):
    desc = np.concatenate([c["desc"][c["valid"]] for c in corners.values()])
    return build(desc, k=4, levels=3, seed=0)


def test_bow_vocabulary_is_the_jax_one():
    _, pt = pipelines()
    voc = _vocabulary(pt.corners, bow.build_vocabulary)
    ref = _vocabulary(pt.corners, jbow.build_vocabulary)
    np.testing.assert_array_equal(voc.centroids, ref.centroids)
    np.testing.assert_array_equal(voc.leaf_word, ref.leaf_word)
    assert voc.children == ref.children
    c = pt.corners[pt.fcids[3]]
    np.testing.assert_array_equal(voc.word_ids(c["desc"]),
                                  ref.word_ids(c["desc"]))


def test_bow_files_round_trip(tmp_path):
    """The copied cereal layer: a vocabulary in the reference's binary
    cereal and a database in its JSON archive come back as they went."""
    _, pt = pipelines()
    voc = _vocabulary(pt.corners, bow.build_vocabulary)
    nodes = [{"id": i, "weight": 1.0, "children": kids,
              "parent": 0, "descriptor": voc.centroids[i],
              "word_id": max(int(voc.leaf_word[i]), 0)}
             for i, kids in enumerate(voc.children)]
    path = str(tmp_path / "voc.cereal")
    cereal_io.save_bow_vocabulary_cereal(path, 4, 3, nodes)
    back = bow.BowVocabulary.load(path)
    c = pt.corners[pt.fcids[5]]
    np.testing.assert_array_equal(back.word_ids(c["desc"]),
                                  voc.word_ids(c["desc"]))
    db = bow.BowDatabase(voc.num_words)
    for fcid in pt.fcids[:3]:
        cc = pt.corners[fcid]
        db.insert(fcid, voc.transform(cc["desc"][cc["valid"]]))
    db.save(str(tmp_path / "db.json"))
    db2 = bow.BowDatabase(voc.num_words)
    db2.load(str(tmp_path / "db.json"))
    v = voc.transform(c["desc"][c["valid"]])
    assert db2.query(v, 3) == db.query(v, 3) and len(db.query(v, 3)) == 3


def test_match_bow_matches_jax_worklist():
    """``match_bow``'s worklist is the JAX package's (its RANSAC stage is
    captured unrun); the port's match_bow then verifies those pairs."""
    pj, pt = pipelines()
    voc = _vocabulary(pt.corners, bow.build_vocabulary)
    pj = copy.copy(pj)
    pj.bow_voc = _vocabulary(pt.corners, jbow.build_vocabulary)
    pj.cfg = JSfmConfig(max_matches_per_pair=MM, num_bow_candidates=3)
    captured = []
    pj._run_pair_matching = lambda ids, mesh=None: captured.append(list(ids))
    pj._save_cache = lambda name: None
    pj.match_bow()

    seq = sequence()
    p2 = SfmPipeline(seq.images, seq.calib,
                     SfmConfig(max_matches_per_pair=MM, num_bow_candidates=3),
                     device="cpu", **QUIET)
    p2.detect_keypoints()
    p2.match_bow()                               # no vocabulary: a no-op
    assert p2.matches == {}
    p2.bow_voc = voc
    ids = p2._bow_worklist()
    assert ids == captured[0] and 0 < len(ids) < 24
    p2.match_bow()
    assert p2.counters["match_pairs"] == len(ids)
    assert sorted(p2.matches) == sorted((p2.fcids[a], p2.fcids[b])
                                        for a, b in ids)
    assert sum(len(md["inliers"]) > 0 for md in p2.matches.values()) >= 0.8 * len(ids)
