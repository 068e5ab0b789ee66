"""The port's SfM map stages against the JAX package's, on the CPU in f64.

Both packages run on one rendered stereo sequence of the indoor room
(``synthetic.synth_stereo_sequence(room_radius=INDOOR_ROOM_RADIUS)``: 6
frames, 12 images of 480x752, EuRoC's double-sphere rig), with the
default ``SfmConfig`` but ``max_matches_per_pair`` = 256, under the
detector's compacted feature count (the JAX package's CPU matcher raises
where the budget exceeds it).

The JAX pipeline runs once from images to ``Stage.DONE``, step by step;
the map state before and after every step is read attribute by attribute
(``interop.map_state_to_numpy``), and the samples of each localisation
wave are drawn again from the key the JAX package used
(``ransac._sample_indices``).  The port takes the JAX pipeline's corners
and matches; each stage test then copies the JAX state at that stage's
boundary into the port (``interop.set_map_state``), runs the port's stage
and compares: tracks equal in order; the initial landmarks and their
inverse depths within 1e-9; candidate lists equal in order; one
localisation wave on the JAX draws with the same inliers and poses within
1e-8; new landmarks equal; BA costs within rtol 1e-6, poses and inverse
depths within 1e-6; the outlier pass's removed ids, counters and log line
equal.  A lockstep run on the JAX draws ends in the JAX package's map:
the same cameras, landmark ids, outlier tracks and ``summary()``, poses
within 1e-6.

Then the pieces on their own: ``outlier_policy`` against the scalar
oracle and the JAX function, the params-file reload, ``map_io`` round
trips between the packages, ``optimize`` on an empty map (the JAX package
raises there), ``apps/sfm.main`` on a EuRoC-layout directory of JPEGs,
and ``apps/evaluate`` and ``scripts/compare_to_reference`` against the
JAX package's on the real EuRoC V1 map of ``runs/``.

Slice E on the same run: ``global_initialize`` of both packages from its
match table and tracks, ``apps/sfm --global-init`` on the JPEGs,
``_refine_intrinsics`` of both packages on the maps after the first three
OPTIMIZE steps, and ``map_stats`` / ``reprojection_stats`` of the
finished map.
"""

import copy
import functools
import json
import os
import pickle
import re

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.features import ransac as jransac
from photometric_bundle_adjustment_tpu.io import map_io as jmap_io
from photometric_bundle_adjustment_tpu.pipeline import (
    sfm_pipeline as jsfm,
)
from photometric_bundle_adjustment_tpu.pipeline.config import (
    SfmConfig as JSfmConfig,
)
from photometric_bundle_adjustment_tpu.utils import pack as jpack
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.io import map_io
from photometric_bundle_adjustment_tpu_torch.models import (
    geometric_ba,
    synthetic,
)
from photometric_bundle_adjustment_tpu_torch.optim import ba
from photometric_bundle_adjustment_tpu_torch.pipeline import sfm_pipeline
from photometric_bundle_adjustment_tpu_torch.pipeline.config import SfmConfig
from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
    SfmPipeline,
    Stage,
)
from photometric_bundle_adjustment_tpu_torch.utils import evaluation

torch.set_num_threads(1)

N_FRAMES, H, W, MM = 6, 480, 752, 256
RHO_ATOL, WAVE_ATOL, BA_ATOL, BA_RTOL = 1e-9, 1e-8, 1e-6, 1e-6
BA_LINE = re.compile(r"BA: cost (\S+) -> (\S+) in (\d+) iterations")


@functools.cache
def sequence():
    return synthetic.synth_stereo_sequence(
        n_frames=N_FRAMES, H=H, W=W,
        room_radius=synthetic.INDOOR_ROOM_RADIUS, device="cpu")


def _step_name(pipe) -> str:
    """The stage ``pipe.next_step()`` runs next (after matching)."""
    if not pipe.tracks:
        return "build_tracks"
    if not pipe.cameras:
        return "init_scene"
    return pipe.stage.name


@functools.cache
def jax_run():
    """The JAX pipeline from images to DONE: (corners, matches, steps,
    summary), ``steps`` a list of dicts (name, before, after, logs, draws,
    loc_cache) for every step after matching."""
    seq = sequence()
    logs, draws = [], []
    orig = jsfm._localize_batch_packed

    def recording(model, buffers, keys, pixel_threshold, num_hypotheses,
                  spec):
        valid = jpack.unpack_tree_bytes(buffers, spec)[-1]
        draws.append(np.stack([
            np.asarray(jransac._sample_indices(k, num_hypotheses, 3, v))
            for k, v in zip(keys, valid)]))
        return orig(model, buffers, keys, pixel_threshold, num_hypotheses,
                    spec)

    jsfm._localize_batch_packed = recording
    try:
        pj = jsfm.SfmPipeline(seq.images, seq.calib,
                              JSfmConfig(max_matches_per_pair=MM),
                              log=logs.append)
        while not (pj.corners and pj.matches):
            pj.next_step()
        corners = copy.deepcopy(pj.corners)
        matches = copy.deepcopy(pj.matches)
        steps = []
        more = True
        while more:
            name = _step_name(pj)
            before = interop.map_state_to_numpy(pj)
            n_logs, n_draws = len(logs), len(draws)
            more = pj.next_step()
            steps.append(dict(
                name=name, before=before,
                after=interop.map_state_to_numpy(pj),
                logs=logs[n_logs:], draws=draws[n_draws:],
                loc_cache={f: (np.array(T), np.array(m)) for f, (T, m) in
                           getattr(pj, "_loc_cache", {}).items()}))
    finally:
        jsfm._localize_batch_packed = orig
    return corners, matches, steps, pj.summary()


def port_pipe(state=None, logs=None):
    """The port's pipeline on the JAX pipeline's corners and matches, its
    map state set to ``state`` if given."""
    seq = sequence()
    corners, matches, _, _ = jax_run()
    p = SfmPipeline(seq.images, seq.calib, SfmConfig(max_matches_per_pair=MM),
                    log=(logs.append if logs is not None else
                         (lambda *a: None)),
                    device="cpu")
    p.corners = copy.deepcopy(corners)
    p.matches = copy.deepcopy(matches)
    if state is not None:
        interop.set_map_state(p, state)
    return p


def steps_named(name):
    return [s for s in jax_run()[2] if s["name"] == name]


def assert_landmarks_equal(got: dict, want: dict, atol: float):
    assert list(got) == list(want)
    for t, lm in want.items():
        g = got[t]
        assert list(g["obs"].items()) == list(lm["obs"].items()), t
        assert list(g["outlier_obs"].items()) == \
            list(lm["outlier_obs"].items()), t
    np.testing.assert_allclose([got[t]["inv_depth"] for t in want],
                               [lm["inv_depth"] for lm in want.values()],
                               rtol=0, atol=atol)


def assert_cameras_equal(got: dict, want: dict, atol: float):
    assert list(got) == list(want)
    for f, T in want.items():
        np.testing.assert_allclose(got[f], T, rtol=0, atol=atol,
                                   err_msg=str(f))


def test_jax_run_exercises_every_stage():
    """The JAX run the stage tests read: every stage ran, one wave
    localised the remaining cameras, the outlier pass removed landmarks."""
    _, _, steps, summary = jax_run()
    names = [s["name"] for s in steps]
    for name in ("build_tracks", "init_scene", "COMPUTE_CANDIDATES",
                 "ADD_CAMERAS", "ADD_LANDMARKS", "OPTIMIZE",
                 "REMOVE_OUTLIERS", "DONE"):
        assert name in names, names
    assert sum(len(s["draws"]) for s in steps) >= 1
    assert any(s["after"]["outlier_tracks"] for s in steps)
    assert f"The map has {2 * N_FRAMES} cameras" in summary, summary


def test_build_tracks_matches_jax():
    step = steps_named("build_tracks")[0]
    logs = []
    p = port_pipe(logs=logs)
    p.build_tracks()
    want = step["after"]["tracks"]
    assert list(p.tracks) == list(want)
    assert [list(tr.items()) for tr in p.tracks.values()] == \
        [list(tr.items()) for tr in want.values()]
    assert logs == step["logs"]


def test_initialize_scene_matches_jax():
    step = steps_named("init_scene")[0]
    logs = []
    p = port_pipe(step["before"], logs)
    p.initialize_scene()
    got = interop.map_state_to_numpy(p)
    assert_cameras_equal(got["cameras"], step["after"]["cameras"], 0.0)
    assert_landmarks_equal(got["landmarks"], step["after"]["landmarks"],
                           RHO_ATOL)
    assert len(got["landmarks"]) > 100
    assert got["stage"] == step["after"]["stage"] == "OPTIMIZE"
    assert logs == step["logs"]


@pytest.mark.parametrize("which", range(2))
def test_candidates_match_jax(which):
    """The first two candidate rounds: the list (fcids and shared tracks,
    in order), the thresholds, the stage and the log line."""
    steps = steps_named("COMPUTE_CANDIDATES")
    step = steps[which]
    logs = []
    p = port_pipe(step["before"], logs)
    p.compute_camera_candidate_set()
    got = interop.map_state_to_numpy(p)
    for k in ("candidates", "stage", "min_localization_inliers",
              "max_cameras_to_add"):
        assert got[k] == step["after"][k], k
    assert logs == step["logs"]


def test_localization_wave_matches_jax():
    """The first ADD_CAMERAS step localises a wave on the JAX draws: every
    member's inliers equal and its pose within 1e-8; the camera added, its
    landmark observations and the log line equal."""
    step = steps_named("ADD_CAMERAS")[0]
    assert len(step["draws"]) == 1
    logs = []
    p = port_pipe(step["before"], logs)
    p.pnp_draws = iter(step["draws"])
    p.add_next_camera()
    assert p.counters["localize_waves"] == 1
    added = [f for f in step["after"]["cameras"]
             if f not in step["before"]["cameras"]]
    assert len(added) == 1
    want_cache = step["loc_cache"]
    assert sorted(p._loc_cache) == sorted(want_cache)
    assert len(want_cache) >= 5
    for f, (T, m) in want_cache.items():
        np.testing.assert_array_equal(p._loc_cache[f][1], m, err_msg=str(f))
        np.testing.assert_allclose(p._loc_cache[f][0], T, rtol=0,
                                   atol=WAVE_ATOL, err_msg=str(f))
    got = interop.map_state_to_numpy(p)
    assert_cameras_equal(got["cameras"], step["after"]["cameras"], WAVE_ATOL)
    assert_landmarks_equal(got["landmarks"], step["after"]["landmarks"], 0.0)
    assert got["candidates"] == step["after"]["candidates"]
    assert logs == step["logs"]


def test_add_new_landmarks_matches_jax():
    step = steps_named("ADD_LANDMARKS")[0]
    logs = []
    p = port_pipe(step["before"], logs)
    p.add_new_landmarks()
    got = interop.map_state_to_numpy(p)
    assert len(got["landmarks"]) > len(step["before"]["landmarks"])
    assert_landmarks_equal(got["landmarks"], step["after"]["landmarks"],
                           RHO_ATOL)
    assert got["candidates"] == step["after"]["candidates"]
    assert got["stage"] == step["after"]["stage"]
    assert logs == step["logs"]


@pytest.mark.parametrize("which", range(3))
def test_optimize_matches_jax(which):
    """Every BA solve of the run: the costs of the log line within rtol
    1e-6, the same iterations, poses and inverse depths within 1e-6."""
    steps = steps_named("OPTIMIZE")
    step = steps[which]
    logs = []
    p = port_pipe(step["before"], logs)
    p.optimize()
    got = interop.map_state_to_numpy(p)
    assert_cameras_equal(got["cameras"], step["after"]["cameras"], BA_ATOL)
    assert_landmarks_equal(got["landmarks"], step["after"]["landmarks"],
                           BA_ATOL)
    assert got["stage"] == step["after"]["stage"]
    assert logs[0] == step["logs"][0]
    (mg,) = [BA_LINE.match(s) for s in logs if BA_LINE.match(s)]
    (mw,) = [BA_LINE.match(s) for s in step["logs"] if BA_LINE.match(s)]
    np.testing.assert_allclose([float(mg[1]), float(mg[2])],
                               [float(mw[1]), float(mw[2])], rtol=BA_RTOL)
    assert mg[3] == mw[3]


def test_remove_outliers_matches_jax():
    """The outlier pass that removes landmarks: the same removed ids, the
    tracks moved to ``outlier_tracks``, the counters and the log line."""
    step = next(s for s in steps_named("REMOVE_OUTLIERS")
                if s["after"]["outlier_tracks"]
                != s["before"]["outlier_tracks"])
    logs = []
    p = port_pipe(step["before"], logs)
    p.remove_outlier_landmarks()
    got = interop.map_state_to_numpy(p)
    assert list(got["outlier_tracks"]) == list(step["after"]["outlier_tracks"])
    assert list(got["tracks"]) == list(step["after"]["tracks"])
    assert_landmarks_equal(got["landmarks"], step["after"]["landmarks"], 0.0)
    assert got["stage"] == step["after"]["stage"]
    assert p.counters["project_calls"] == 1
    assert logs == step["logs"] and logs
    # the per-image records, built lazily from the pass's arrays
    proj = p.image_projections
    n_rows = sum(len(lm["obs"]) + len(lm["outlier_obs"])
                 for lm in step["before"]["landmarks"].values())
    assert sum(len(r["obs"]) + len(r["outlier_obs"])
               for r in proj.values()) == n_rows
    assert set(proj) <= set(step["before"]["cameras"])
    rec = next(iter(proj.values()))["obs"][0]
    assert set(rec) == {"fcid", "err", "flags", "uv_proj"}


def test_lockstep_run_matches_jax():
    """From the JAX package's matches, on its draws, the port's ``run``
    ends in the JAX package's map and summary."""
    corners, matches, steps, summary = jax_run()
    logs = []
    p = port_pipe(logs=logs)
    p.pnp_draws = iter([d for s in steps for d in s["draws"]])
    p.run()
    want = steps[-1]["after"]
    got = interop.map_state_to_numpy(p)
    assert sorted(got["cameras"]) == sorted(want["cameras"])
    for f, T in want["cameras"].items():
        np.testing.assert_allclose(got["cameras"][f], T, rtol=0,
                                   atol=BA_ATOL, err_msg=str(f))
    assert list(got["landmarks"]) == list(want["landmarks"])
    assert list(got["outlier_tracks"]) == list(want["outlier_tracks"])
    assert p.summary() == summary
    assert logs[-1] == summary
    assert p.counters["ba_solves"] == len(steps_named("OPTIMIZE"))
    # the map against the rendered ground truth
    seq = sequence()
    est = evaluation.trajectory_from_cameras(p.cameras)
    gt = np.stack([seq.poses_gt[(f, 0)][:3] for f in range(N_FRAMES)])
    assert evaluation.ate_rmse(est, gt) < 5e-3
    stats = dict(zip(("rows", "err", "flags"), p.compute_projections()))
    inl = ~np.array([r[3] for r in stats["rows"]])
    assert np.sqrt(np.mean(stats["err"][inl] ** 2)) < 1.0


def test_native_tracks_insertion_order_drives_candidates():
    """The candidates rank shared tracks by landmark insertion and sort
    stably by count: a camera whose shared tracks tie keeps fcid order."""
    step = steps_named("COMPUTE_CANDIDATES")[0]
    p = port_pipe(step["before"])
    p.compute_camera_candidate_set()
    counts = [len(c.shared_tracks) for c in p.candidates]
    assert counts == sorted(counts, reverse=True)
    rank = {t: i for i, t in enumerate(p.landmarks)}
    for c in p.candidates:
        assert [rank[t] for t in c.shared_tracks] == \
            sorted(rank[t] for t in c.shared_tracks)
    for a, b in zip(p.candidates, p.candidates[1:]):
        if len(a.shared_tracks) == len(b.shared_tracks):
            assert a.fcid < b.fcid


def test_image_track_index_follows_every_change():
    """The per-image track index is rebuilt when tracks are replaced,
    resized or changed in place with the same length."""
    step = steps_named("COMPUTE_CANDIDATES")[0]
    p = port_pipe(step["before"])
    idx, _ = p._image_track_index()
    tid = next(iter(p.tracks))
    fcid = next(iter(p.tracks[tid]))
    assert tid in idx[fcid]
    # in place, same length: pop one track, insert another
    tr = p.tracks.pop(tid)
    p.tracks[10 ** 9] = tr
    p._tracks_version += 1
    idx, order = p._image_track_index()
    assert tid not in idx[fcid] and 10 ** 9 in idx[fcid]
    assert order[10 ** 9] == len(p.tracks) - 1
    # replaced by an equal-length dict
    p.tracks = {t: dict(v) for t, v in reversed(list(p.tracks.items()))}
    _, order = p._image_track_index()
    assert order[10 ** 9] == 0


# ---------------------------------------------------------------------------
# the pieces on their own
# ---------------------------------------------------------------------------


def _outlier_oracle(tid_k, fl):
    """The reference's per-track scan loop (sfm.cpp:2028-2131), verbatim
    semantics (the scalar oracle of tests/test_pipeline.py)."""
    O = sfm_pipeline
    track = {}
    for t, f in zip(tid_k.tolist(), fl.tolist()):
        track.setdefault(t, []).append(f)
    any_severe = any(f & ~O.OUTLIER_REPROJECTION_NORMAL
                     for fs in track.values() for f in fs)
    n_normal = n_huge = n_dist = n_z = 0
    removed = []
    for tid, fs in track.items():
        remove = normal_counted = False
        for f in fs:
            if f & O.OUTLIER_REPROJECTION_HUGE:
                n_huge += 1
                remove = True
                break
            if f & O.OUTLIER_REPROJECTION_NORMAL:
                if not normal_counted:
                    n_normal += 1
                    normal_counted = True
                if not any_severe:
                    remove = True
                    break
            if f & O.OUTLIER_CAMERA_DISTANCE:
                remove = True
                n_dist += 1
                break
            if f & O.OUTLIER_Z_COORDINATE:
                remove = True
                n_z += 1
                break
        if remove:
            removed.append(tid)
    return removed, n_huge, n_normal, n_dist, n_z, any_severe


@pytest.mark.parametrize("seed", range(3))
def test_outlier_policy_matches_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    for trial in range(100):
        rows_t, rows_f = [], []
        for t in range(int(rng.integers(1, 30))):
            for _ in range(int(rng.integers(1, 8))):
                rows_t.append(t * 7 + 3)
                if trial % 3 == 0:
                    f = int(rng.choice([0, 0, 0, 2]))
                else:
                    f = int(rng.integers(0, 16)) if rng.random() < 0.3 else 0
                rows_f.append(f)
        tid_k = np.asarray(rows_t, np.int64)
        fl = np.asarray(rows_f, np.int32)
        got = sfm_pipeline.outlier_policy(tid_k, fl)
        assert got == _outlier_oracle(tid_k, fl), trial
        assert got == jsfm.outlier_policy(tid_k, fl), trial
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int32))
    assert sfm_pipeline.outlier_policy(*empty) == ([], 0, 0, 0, 0, False)


def test_params_file_live_reload(tmp_path):
    """SfmConfig fields update in place between steps; unknown keys,
    bad values and half-written files are logged and skipped."""
    seq = sequence()
    pf = tmp_path / "params.json"
    logs = []
    pipe = SfmPipeline(seq.images, seq.calib, log=logs.append,
                       params_file=str(pf), device="cpu")
    pipe._maybe_reload_params()  # file absent: no-op
    assert pipe.cfg.feature_match_max_dist == 70
    pf.write_text(json.dumps({
        "feature_match_max_dist": 50, "reprojection_error_huber_pixel": 2,
        "rotate_features": "false", "no_such_knob": 1}))
    pipe._maybe_reload_params()
    assert pipe.cfg.feature_match_max_dist == 50
    assert pipe.cfg.reprojection_error_huber_pixel == 2.0
    assert isinstance(pipe.cfg.reprojection_error_huber_pixel, float)
    assert pipe.cfg.rotate_features is True
    assert any("unknown parameter" in s for s in logs)
    assert any("non-boolean value" in s for s in logs)
    assert any("Parameters updated" in s for s in logs)
    pipe._maybe_reload_params()  # unchanged stamp: no re-read
    pf.write_text("{not json")
    os.utime(pf, (1e9, 1e9 + 1))
    pipe._maybe_reload_params()
    assert any("not reloaded" in s for s in logs)
    assert pipe.cfg.feature_match_max_dist == 50
    # the pipeline holds a copy: the default config is untouched
    assert SfmConfig().feature_match_max_dist == 70


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_map_io_round_trip_between_packages(tmp_path, direction):
    """A finished map saved by one package loads in the other, equal."""
    state = jax_run()[2][-1]["after"]
    p = port_pipe(state)
    path = str(tmp_path / "map.npz")
    save, load = ((map_io.save_map, jmap_io.load_map)
                  if direction == "port_to_jax"
                  else (jmap_io.save_map, map_io.load_map))
    save(path, p)
    cameras, landmarks, tracks, outlier_tracks = load(path)
    assert sorted(cameras) == sorted(state["cameras"])
    for f, T in state["cameras"].items():
        np.testing.assert_array_equal(cameras[f], T)
    assert sorted(landmarks) == sorted(state["landmarks"])
    for t, lm in state["landmarks"].items():
        assert landmarks[t]["inv_depth"] == lm["inv_depth"]
        assert landmarks[t]["obs"] == lm["obs"]
        assert landmarks[t]["outlier_obs"] == lm["outlier_obs"]
    assert tracks == state["tracks"]
    assert outlier_tracks == state["outlier_tracks"]


def test_optimize_on_empty_map_skips_and_finishes():
    """Every landmark gone: ``optimize`` logs the skip instead of raising
    (the JAX package's plan builder raises IndexError there), and the
    stage machine goes on to DONE."""
    state = steps_named("init_scene")[0]["after"]
    state = dict(state, landmarks={})
    logs = []
    p = port_pipe(state, logs)
    p.optimize()
    assert "Skipping bundle adjustment: the map has no landmarks." in logs
    assert p.stage == Stage.REMOVE_OUTLIERS
    assert "ba_solves" not in p.counters
    p.run()
    assert p.stage == Stage.DONE
    assert any("Did not find any camera candidates" in s for s in logs)
    assert p.summary().startswith("The map has 2 cameras and 0 landmarks")


def test_bundle_adjustment_without_landmarks():
    """L = 0: the problem comes back unchanged at cost 0."""
    K = 3
    prob = geometric_ba.build_problem(
        poses=np.tile([0, 0, 0, 0, 0, 0, 1.0], (K, 1)), inv_depth=np.zeros(0),
        anchor_cam=np.zeros(0, np.int64), target_cam=np.zeros(0, np.int64),
        landmark=np.zeros(0, np.int64), uv_target=np.zeros((0, 2)),
        uv_ref=np.zeros((0, 2)), intr_ref=np.zeros((0, 8)),
        intr_target=np.zeros((0, 8)), valid=np.zeros(0, bool),
        fixed_cams=np.array([True, True, False]), device="cpu")
    out, res = geometric_ba.bundle_adjustment(prob, "ds", ba.BAConfig())
    assert out is prob
    assert float(res.cost) == float(res.initial_cost) == 0.0
    assert res.iterations == 0


def _write_euroc_dir(root, seq, n_frames):
    """A EuRoC-layout directory (timestamps.txt, <ts>_<cam>.jpg) of the
    sequence's first frames, and a calibration JSON of its rig."""
    Image = pytest.importorskip("PIL.Image")
    data = root / "data"
    data.mkdir()
    stamps = [1403715273262142976 + 50_000_000 * i for i in range(n_frames)]
    (data / "timestamps.txt").write_text("\n".join(map(str, stamps)) + "\n")
    for i, ts in enumerate(stamps):
        for cam in range(2):
            Image.fromarray(seq.images[(i, cam)]).save(
                data / f"{ts}_{cam}.jpg", quality=95)
    c = seq.calib
    calib = {"value0": {
        "cam.T_i_c": [dict(zip(("px", "py", "pz", "qx", "qy", "qz", "qw"),
                               map(float, T))) for T in c.T_i_c],
        "cam.intrinsics": [
            dict(cam_type="ds", width=W, height=H,
                 **dict(zip(("fx", "fy", "cx", "cy", "p1", "p2", "p3", "p4"),
                            map(float, k)))) for k in c.intrinsics]}}
    path = root / "calib.json"
    path.write_text(json.dumps(calib))
    return data, path


APP_FRAMES = 3


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    """A EuRoC-layout directory of the sequence's first APP_FRAMES frames,
    its calibration JSON and a corners/matches cache directory, shared by
    the app's runs (a later run loads the caches an earlier one saved)."""
    root = tmp_path_factory.mktemp("euroc")
    data, calib = _write_euroc_dir(root, sequence(), APP_FRAMES)
    return data, calib, root / "cache"


@pytest.mark.parametrize("map_out", ["map.pkl", "map.cereal"])
def test_sfm_app_on_cpu(tmp_path, euroc_dir, map_out):
    """``apps/sfm.main --device cpu`` from JPEGs to a map file and a stats
    record; every image registered, the map within 5 mm of the rendered
    trajectory."""
    from photometric_bundle_adjustment_tpu_torch.apps import sfm as app
    from photometric_bundle_adjustment_tpu_torch.io import cereal_io

    seq = sequence()
    n = APP_FRAMES
    data, calib, cache = euroc_dir
    out = tmp_path / map_out
    stats_path = tmp_path / "stats.json"
    assert app.main([
        "--dataset-path", str(data), "--cam-calib", str(calib),
        "--map-out", str(out), "--stats-out", str(stats_path),
        "--device", "cpu", "--cache-dir", str(cache),
    ]) == 0
    stats = json.loads(stats_path.read_text())
    assert stats["n_images"] == 2 * n
    assert stats["device"] == "cpu"
    assert stats["counters"]["ba_solves"] >= 1
    assert stats["summary"].startswith(f"The map has {2 * n} cameras")
    for k in ("build_tracks", "ba", "add_cameras"):
        assert k in stats["timings_s"] and k in stats["timings_dev_s"]
    assert (cache / "corners.pkl").exists()
    assert (cache / "matches.pkl").exists()
    if map_out.endswith(".pkl"):
        with open(out, "rb") as f:
            m = pickle.load(f)
        cameras = m["cameras"]
        assert len(m["timestamps"]) == n and m["landmarks"]
    else:
        cameras = cereal_io.load_map_cereal(str(out))["cameras"]
    assert len(cameras) == 2 * n
    est = evaluation.trajectory_from_cameras(cameras)
    gt = np.stack([seq.poses_gt[(f, 0)][:3] for f in range(n)])
    assert evaluation.ate_rmse(est, gt) < 5e-3


def test_sfm_app_default_stats_record(tmp_path, euroc_dir, monkeypatch):
    """Without ``--stats-out`` the app writes the port's own record,
    runs/last_run_stats_torch.json under the working directory, naming
    its backend, which the port's bench reads; it never writes
    runs/last_run_stats.json, the JAX package's committed TPU record."""
    from photometric_bundle_adjustment_tpu_torch import bench
    from photometric_bundle_adjustment_tpu_torch.apps import sfm as app

    data, calib, cache = euroc_dir
    monkeypatch.chdir(tmp_path)
    assert app.main([
        "--dataset-path", str(data), "--cam-calib", str(calib),
        "--map-out", "map.pkl", "--device", "cpu", "--cache-dir", str(cache),
    ]) == 0
    assert not (tmp_path / "runs" / "last_run_stats.json").exists()
    stats = bench.load_port_stats(tmp_path / "runs"
                                  / "last_run_stats_torch.json")
    assert (stats["backend"], stats["device"]) == ("cpu", "cpu")
    assert stats["n_images"] == 2 * APP_FRAMES


def test_sfm_app_global_init_on_cpu(tmp_path, euroc_dir):
    """``apps/sfm.main --global-init --device cpu`` from JPEGs: tracks,
    rotation and translation averaging, triangulation, then BA and the
    rest of ``run`` to ``Stage.DONE``; every image registered, the map
    within 2 cm of the rendered trajectory (measured 9.7 mm, where the
    incremental run's is 0.7 mm: averaging over 3 frames leaves the BA a
    worse start)."""
    from photometric_bundle_adjustment_tpu_torch.apps import sfm as app

    seq = sequence()
    n = APP_FRAMES
    data, calib, cache = euroc_dir
    out = tmp_path / "map.pkl"
    stats_path = tmp_path / "stats.json"
    assert app.main([
        "--dataset-path", str(data), "--cam-calib", str(calib),
        "--map-out", str(out), "--stats-out", str(stats_path),
        "--device", "cpu", "--global-init",
    ]) == 0
    stats = json.loads(stats_path.read_text())
    assert stats["summary"].startswith(f"The map has {2 * n} cameras")
    # no incremental localisation: averaging placed every camera
    assert stats["counters"].get("localize_waves", 0) == 0
    assert stats["counters"]["ba_solves"] >= 1
    with open(out, "rb") as f:
        m = pickle.load(f)
    assert len(m["cameras"]) == 2 * n and m["landmarks"]
    est = evaluation.trajectory_from_cameras(m["cameras"])
    gt = np.stack([seq.poses_gt[(f, 0)][:3] for f in range(n)])
    assert evaluation.ate_rmse(est, gt) < 2e-2


def jax_pipe(state, logs=None):
    """The JAX pipeline on its own corners and matches, its map state set
    to ``state``, its calibration a copy."""
    seq = sequence()
    corners, matches, _, _ = jax_run()
    pj = jsfm.SfmPipeline(seq.images, copy.deepcopy(seq.calib),
                          JSfmConfig(max_matches_per_pair=MM),
                          log=(logs.append if logs is not None else
                               (lambda *a: None)))
    pj.corners = copy.deepcopy(corners)
    pj.matches = copy.deepcopy(matches)
    pj.cameras = {f: np.array(T) for f, T in state["cameras"].items()}
    pj.landmarks = {t: jsfm.Landmark(d["inv_depth"], dict(d["obs"]),
                                     dict(d["outlier_obs"]))
                    for t, d in state["landmarks"].items()}
    pj.tracks = {t: dict(tr) for t, tr in state["tracks"].items()}
    pj.outlier_tracks = {t: dict(tr)
                         for t, tr in state["outlier_tracks"].items()}
    return pj


def test_global_initialize_matches_jax():
    """Both packages' ``global_initialize`` from the cached run's match
    table and tracks: the same cameras within 1e-8, the same landmark ids
    in the same order (the first camera pair that triangulates a track
    sets it), inverse depths within 1e-8 and the same log lines."""
    from photometric_bundle_adjustment_tpu.pipeline import (
        global_init as jglobal,
    )

    from photometric_bundle_adjustment_tpu_torch.pipeline import global_init

    state = steps_named("build_tracks")[0]["after"]
    logs_j, logs_t = [], []
    pj = jax_pipe(state)
    fj = jglobal.global_initialize(pj, log=logs_j.append)
    p = port_pipe(state)
    ft = global_init.global_initialize(p, log=logs_t.append)
    assert ft == fj and len(ft) == 2 * N_FRAMES
    assert logs_t == logs_j
    want = interop.map_state_to_numpy(pj)
    got = interop.map_state_to_numpy(p)
    assert_cameras_equal(got["cameras"], want["cameras"], 1e-8)
    assert_landmarks_equal(got["landmarks"], want["landmarks"], 1e-8)
    stats = p.global_init_stats
    assert stats["cameras"] == 2 * N_FRAMES
    assert stats["triangulation"]["landmarks"] == len(p.landmarks) > 0
    assert stats["rotation"]["cost"] <= stats["rotation"]["initial_cost"]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_refine_intrinsics_matches_jax(which):
    """``SfmPipeline._refine_intrinsics`` (``ba_optimize_intrinsics``) of
    both packages on the map after each of the cached run's first three
    OPTIMIZE steps: intrinsics within 1e-9 relative, the same log line."""
    state = steps_named("OPTIMIZE")[which]["after"]
    cfg = dict(max_matches_per_pair=MM, ba_verbose=1)
    logs_j, logs_t = [], []
    pj = jax_pipe(state, logs_j)
    pj.cfg = JSfmConfig(**cfg)
    pj._refine_intrinsics()
    p = port_pipe(state, logs_t)
    p.cfg = SfmConfig(**cfg)
    p.calib = copy.deepcopy(p.calib)
    before = np.array(p.calib.intrinsics)
    p._refine_intrinsics()
    got, want = np.asarray(p.calib.intrinsics), np.asarray(
        pj.calib.intrinsics)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert not np.array_equal(got, before)
    assert logs_t == logs_j and len(logs_t) == 1


def test_map_stats_and_reprojection_stats_match_jax():
    """``utils/evaluation.map_stats`` and ``reprojection_stats`` of both
    packages on the cached run's finished map."""
    from photometric_bundle_adjustment_tpu.utils import (
        evaluation as jevaluation,
    )

    state = jax_run()[2][-1]["after"]
    pj, p = jax_pipe(state), port_pipe(state)
    assert evaluation.map_stats(p) == jevaluation.map_stats(pj)
    assert evaluation.map_stats(p)["cameras"] == 2 * N_FRAMES
    got, want = (evaluation.reprojection_stats(p),
                 jevaluation.reprojection_stats(pj))
    assert got["count"] == want["count"] > 0
    for k in ("mean_px", "median_px", "p95_px", "max_px"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    empty = port_pipe()
    assert evaluation.reprojection_stats(empty) == {"count": 0}


MAP_R5 = os.path.join(os.path.dirname(__file__), "..", "runs",
                      "map_r5_run20.pkl")
REF_DUMP = os.path.join(os.path.dirname(__file__), "..", "refbaseline",
                        "artifacts", "run_v1_trajectory.txt")


def test_compare_to_reference_matches_jax(capsys):
    """The port's script prints the JAX script's table on the real EuRoC
    V1 map of ``runs/`` against the reference run's dump."""
    import importlib.util

    from photometric_bundle_adjustment_tpu_torch.scripts import (
        compare_to_reference as port_cmp,
    )

    spec = importlib.util.spec_from_file_location(
        "jax_compare_to_reference",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "compare_to_reference.py"))
    jax_cmp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cmp)
    args = ["--ref-dump", REF_DUMP, "--our-map", MAP_R5]
    jax_cmp.main(args)
    want = capsys.readouterr().out
    port_cmp.main(args)
    got = capsys.readouterr().out
    assert got == want
    assert "shared cameras: 164" in got


@pytest.mark.parametrize("ref", [False, True])
def test_evaluate_app_matches_jax(tmp_path, capsys, ref):
    """``apps/evaluate`` of both packages on the real map (and against a
    map_io copy of the lockstep map's JAX state) print the same JSON."""
    from photometric_bundle_adjustment_tpu.apps import evaluate as jeval

    from photometric_bundle_adjustment_tpu_torch.apps import evaluate

    args = ["--map", MAP_R5]
    if ref:
        with open(MAP_R5, "rb") as f:
            m = pickle.load(f)
        m["cameras"] = {k: np.asarray(T) + np.r_[1e-3, 0, 0, 0, 0, 0, 0]
                        for k, T in m["cameras"].items()}
        path = tmp_path / "shifted.pkl"
        with open(path, "wb") as f:
            pickle.dump(m, f)
        args += ["--ref", str(path), "--with-scale"]
    jeval.main(args)
    want = json.loads(capsys.readouterr().out)
    evaluate.main(args)
    got = json.loads(capsys.readouterr().out)
    assert got == want
    assert got["cameras"] == 164
    # a map_io file loads through the same path
    state = jax_run()[2][-1]["after"]
    npz = str(tmp_path / "map.npz")
    map_io.save_map(npz, port_pipe(state))
    evaluate.main(["--map", npz])
    assert json.loads(capsys.readouterr().out)["cameras"] == 2 * N_FRAMES
