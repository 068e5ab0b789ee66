"""The port's SfM front end against the JAX package's, end to end on the CPU:
both packages' ``SfmPipeline`` run on one small rendered stereo sequence
(8 images of 120x160, EuRoC's double-sphere rig and stereo extrinsics),
then detection, stereo matching with the epipolar check, and all-pairs
descriptor matching over the pair worklist are compared.  Every
comparison is exact: the corners, descriptors and match lists are
integers or integer-valued."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from photometric_bundle_adjustment_tpu.features import match as jmatch
from photometric_bundle_adjustment_tpu.features import (
    pair_matching as jpair_matching,
)
from photometric_bundle_adjustment_tpu.pipeline.config import (
    SfmConfig as JSfmConfig,
)
from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
    SfmPipeline as JSfmPipeline,
)
from photometric_bundle_adjustment_tpu_torch.features import (
    match,
    pair_matching,
)
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.pipeline.config import SfmConfig
from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
    SfmPipeline,
)

torch.set_num_threads(1)

MM = 64   # all-pairs match budget at this size


@functools.cache
def pipelines():
    """(JAX pipeline, port pipeline, sequence) after detect_keypoints and
    match_stereo on the same images."""
    seq = synthetic.synth_stereo_sequence(n_frames=4, H=120, W=160, cell=2.0,
                                          device="cpu")
    quiet = dict(log=lambda *a: None)
    pj = JSfmPipeline(seq.images, seq.calib, JSfmConfig(match_chunk_pairs=4),
                      seed=0, **quiet)
    pt = SfmPipeline(seq.images, seq.calib, SfmConfig(match_chunk_pairs=4),
                     device="cpu", **quiet)
    for p in (pj, pt):
        p.detect_keypoints()
        p.match_stereo()
    return pj, pt, seq


def test_detect_keypoints_matches_jax():
    pj, pt, _ = pipelines()
    assert sorted(pt.corners) == sorted(pj.corners) == pt.fcids
    for k in pt.fcids:
        a, b = pt.corners[k], pj.corners[k]
        np.testing.assert_array_equal(a["uv"], np.asarray(b["uv"]))
        np.testing.assert_array_equal(a["valid"], np.asarray(b["valid"]))
        np.testing.assert_array_equal(a["desc"], np.asarray(b["desc"]))
        assert a["desc"].dtype == np.uint32
        v = a["valid"]
        np.testing.assert_allclose(a["angles"][v], np.asarray(b["angles"])[v],
                                   atol=1e-5)
        assert v.sum() >= 30
    assert pt.counters["detect_batches"] == pj.counters["detect_batches"]


def test_match_stereo_matches_jax():
    pj, pt, _ = pipelines()
    assert sorted(pt.matches) == sorted(pj.matches)
    n_inliers = 0
    for key, m in pt.matches.items():
        r = pj.matches[key]
        np.testing.assert_array_equal(m["matches"], r["matches"])
        np.testing.assert_array_equal(m["inliers"], r["inliers"])
        np.testing.assert_allclose(m["T_i_j"], np.asarray(r["T_i_j"]),
                                   atol=1e-12)
        assert m["matches"].dtype == np.int32
        n_inliers += len(m["inliers"])
    assert n_inliers > 0
    assert pt.counters["stereo_pairs"] == pj.counters["stereo_pairs"] == 4
    # every stereo pair goes through one batch: one launch per direction
    assert pt.counters["stereo_chunks"] == 1


def test_stereo_inliers_land_on_ground_truth():
    """Through the rendered geometry, the stereo inliers' right-image
    corners lie within 2 px of the true correspondence of their left
    corners."""
    _, pt, seq = pipelines()
    close = total = 0
    for ((f, _), _), m in pt.matches.items():
        inl = m["inliers"]
        uv_l = pt.corners[(f, 0)]["uv"][inl[:, 0]]
        uv_r = pt.corners[(f, 1)]["uv"][inl[:, 1]]
        uv_t, front = seq.correspondence((f, 0), (f, 1), uv_l)
        err = np.linalg.norm(uv_t - uv_r, axis=1)
        close += int(((err <= 2.0) & front).sum())
        total += len(inl)
    assert total > 0 and close >= 0.8 * total, (close, total)


def test_match_pairs_over_worklist_matches_jax():
    """``match_pairs`` over the whole non-stereo worklist, then
    ``matches_to_pairs``: identical to the JAX matcher vmapped over the
    same pairs, and to its numpy compaction, as is the port's
    ``compact_matches_np``."""
    pj, pt, _ = pipelines()
    ids = pt._pair_worklist()
    assert ids == pj._pair_worklist() and len(ids) == 24
    i1 = np.array([a for a, _ in ids])
    i2 = np.array([b for _, b in ids])
    _, valid, desc, _ = pt._stack_features()
    cfg = pt.cfg
    got = pair_matching.match_pairs(desc, valid, i1, i2,
                                    cfg.feature_match_max_dist,
                                    cfg.feature_match_test_next_best).numpy()

    _, jvalid, jdesc, _ = pj._stack_features()
    ref = np.asarray(jax.vmap(
        lambda a, b: jmatch.match_descriptors(
            jdesc[a], jdesc[b], jvalid[a], jvalid[b],
            cfg.feature_match_max_dist, cfg.feature_match_test_next_best)
    )(jnp.asarray(i1), jnp.asarray(i2)))
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).sum() > 0
    ref_c = jpair_matching.compact_matches_np(ref, MM)
    dev_c = match.matches_to_pairs(torch.as_tensor(got), MM)
    for g, d, r in zip(pair_matching.compact_matches_np(got, MM), dev_c,
                       ref_c):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(d.numpy(), r)


def test_profile_frontend_on_plain_path():
    """The front end's profiling entry point runs on the CPU plain path and
    reports every stage, ``match_all``'s RANSAC stages included; the
    device fields stay empty off the card."""
    from photometric_bundle_adjustment_tpu_torch import profile_frontend

    res = profile_frontend.main(["--device", "cpu", "--frames", "3", "--H",
                                 "120", "--W", "160", "--reps", "1"])
    assert res["images"] == 6 and res["pairs"] == 12 and res["F"] == 128
    for k in ("detect_ms", "match_stereo_ms", "match_pairs_ms", "batch_ms",
              "shi_tomasi_ms", "compute_descriptors_ms"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    for k in ("sample_ms", "five_point_ms", "prescreen_ms", "score_ms",
              "refine_ms", "inliers_ms", "consume_ms"):
        assert np.isfinite(res["ransac_chunk_ms"][k]), k
    assert res["match_all_ms"] > 0 and res["ransac_chunks"] == 1
    for p in (res["detect_profile"], res["match_stereo_profile"],
              res["match_pairs_profile"], res["match_all_profile"]):
        assert p["top_self_ms"] and p["device_busy_ms"] is None
    assert res["peak_device_mib"] is None
