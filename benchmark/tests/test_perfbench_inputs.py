"""The benchmark's frozen inputs against the program's own generators, on
the CPU: the room and the synthetic BA scene bit for bit at small sizes,
and the frozen real V1 map against SfM's BA problem of the same map."""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.tools import freeze_v1map

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(K=8, L=40, H=48, W=80, obs_per_lm=3, long_tracks=6, seed=3),
    dict(K=12, L=64, H=64, W=96, obs_per_lm=4, long_tracks=0, seed=5,
         model="pinhole", max_track=9),
])
def test_room_equals_synth_pba_pipe(kw):
    from photometric_bundle_adjustment_tpu_torch.models import synthetic

    a = scenes.room_pipe(**kw)
    b = synthetic.synth_pba_pipe(**kw)
    assert a.images.keys() == b.images.keys()
    for k in b.images:
        assert np.array_equal(a.images[k], b.images[k])
        assert np.array_equal(a.cameras[k], b.cameras[k])
        assert np.array_equal(a.poses_gt[k], b.poses_gt[k])
        assert np.array_equal(a.corners[k]["uv"], b.corners[k]["uv"])
    assert a.landmarks.keys() == b.landmarks.keys()
    for t in b.landmarks:
        assert a.landmarks[t].obs == b.landmarks[t].obs
        assert a.landmarks[t].inv_depth == b.landmarks[t].inv_depth
    assert np.array_equal(a.calib.intrinsics, b.calib.intrinsics)


@pytest.mark.parametrize("kw", [
    dict(K=8, L=96, obs_per_landmark=4, seed=1),
    dict(K=16, L=200, obs_per_landmark=8, seed=9, pixel_noise=0.5),
])
def test_synth_ba_equals_synth_ba_problem(kw):
    from photometric_bundle_adjustment_tpu_torch.models import synthetic

    req, poses_gt, rho_gt = scenes.synth_ba_arrays(**kw)
    prob, p_gt, r_gt = synthetic.synth_ba_problem(device="cpu", **kw)
    o = prob.obs
    assert np.array_equal(req.poses, prob.cam_states.numpy())
    assert np.array_equal(req.inv_depth, prob.inv_depth.numpy())
    assert np.array_equal(poses_gt, p_gt.numpy())
    assert np.array_equal(rho_gt, r_gt.numpy())
    for mine, theirs in ((req.anchor_cam, o.anchor_cam),
                         (req.target_cam, o.target_cam),
                         (req.landmark, o.landmark),
                         (req.uv_target, o.aux.uv_target),
                         (req.uv_ref, o.aux.uv_ref),
                         (req.intr_ref, o.aux.intr_ref),
                         (req.intr_target, o.aux.intr_target),
                         (req.fixed, prob.fixed_cams)):
        assert np.array_equal(mine, theirs.numpy())


def test_v1map_equals_sfm_ba_problem():
    """benchmark/data/v1map.npz is SfM's BA problem of the committed V1
    map, and the freezing script makes it again from the three files."""
    from photometric_bundle_adjustment_tpu_torch.io import calib_io
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    with open(freeze_v1map.MAP, "rb") as f:
        m = pickle.load(f)
    with open(freeze_v1map.CORNERS, "rb") as f:
        corners = pickle.load(f)["data"]
    calib = calib_io.load_calibration(str(freeze_v1map.CALIB))
    pipe = SfmPipeline.from_map(m, corners, calib, log=lambda s: None,
                                device="cpu")
    prob, cams, lms = pipe._build_ba_problem(dtype=torch.float64)
    req = scenes.load_map(scenes.DATA / "v1map.npz")
    o = prob.obs
    assert req.model == calib.cam_types[0] == "ds"
    assert (req.poses.shape, req.inv_depth.shape, req.landmark.shape) == (
        (164, 7), (5468,), (23318,))
    assert np.array_equal(req.poses, prob.cam_states.numpy())
    assert np.array_equal(req.inv_depth, prob.inv_depth.numpy())
    for mine, theirs in ((req.anchor_cam, o.anchor_cam),
                         (req.target_cam, o.target_cam),
                         (req.landmark, o.landmark),
                         (req.uv_target, o.aux.uv_target),
                         (req.uv_ref, o.aux.uv_ref),
                         (req.intr_ref, o.aux.intr_ref),
                         (req.intr_target, o.aux.intr_target),
                         (req.fixed, prob.fixed_cams)):
        assert np.array_equal(mine, theirs.numpy())

    fresh = freeze_v1map.problem_arrays(*freeze_v1map.load_inputs())
    with np.load(scenes.DATA / "v1map.npz") as z:
        assert sorted(z.files) == sorted(fresh)
        for k in fresh:
            assert np.array_equal(z[k], fresh[k]), k


def test_requests_repeat_and_differ():
    """A request is a function of (seed, index): the same pair gives the
    same input, another index another perturbation and landmark subset."""
    traffic = json.loads((scenes.DATA.parent / "traffic" / "v1map.json")
                         .read_text())
    scene = scenes.make_scene(traffic, 2 ** 33 + 1)
    a, b, c = scene.request(4), scene.request(4), scene.request(5)
    for k in ("poses", "inv_depth", "landmark", "uv_target"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert not np.array_equal(a.poses, c.poses)
    assert a.landmark.shape != c.landmark.shape or not np.array_equal(
        a.landmark, c.landmark)
    kept = a.inv_depth.shape[0] / scene.base.inv_depth.shape[0]
    assert 0.93 < kept < 0.97
    # the fixed cameras keep their saved poses
    assert np.array_equal(a.poses[a.fixed], scene.base.poses[a.fixed])
