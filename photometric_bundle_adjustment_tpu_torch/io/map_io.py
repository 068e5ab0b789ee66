"""Array-native map persistence.

A copy of ``photometric_bundle_adjustment_tpu/io/map_io.py`` (numpy only):
the two packages read each other's files.  Replaces the reference's cereal
binary map archive (save_map_file / load_map_file, map_utils.h:58-116)
with a documented npz container: all map state as flat arrays (poses,
inverse depths, observation COO triplets) plus a small JSON header.  Loads
back into the same host-side dict structures the pipeline uses; symmetric
with ``SfmPipeline`` state.
"""

from __future__ import annotations

import json

import numpy as np


def save_map(path: str, pipe) -> None:
    """Save cameras, landmarks (inv depth + obs/outlier_obs), tracks."""
    cam_list = sorted(pipe.cameras)
    lm_list = sorted(pipe.landmarks)
    cam_index = {f: i for i, f in enumerate(cam_list)}

    obs_rows = []       # (lm_idx, cam_idx, feature, is_outlier)
    for li, t in enumerate(lm_list):
        lm = pipe.landmarks[t]
        for fcid, feat in lm.obs.items():
            obs_rows.append((li, cam_index[fcid], feat, 0))
        for fcid, feat in lm.outlier_obs.items():
            if fcid in cam_index:
                obs_rows.append((li, cam_index[fcid], feat, 1))
    obs = np.asarray(obs_rows, np.int64).reshape(-1, 4)

    track_rows = []     # (track_id, frame, cam, feature, is_outlier_track)
    for t, tr in pipe.tracks.items():
        for (f, c), feat in tr.items():
            track_rows.append((t, f, c, feat, 0))
    for t, tr in pipe.outlier_tracks.items():
        for (f, c), feat in tr.items():
            track_rows.append((t, f, c, feat, 1))
    tracks = np.asarray(track_rows, np.int64).reshape(-1, 5)

    np.savez_compressed(
        path,
        header=np.frombuffer(
            json.dumps(
                {
                    "version": 1,
                    "num_cameras": len(cam_list),
                    "num_landmarks": len(lm_list),
                }
            ).encode(), np.uint8,
        ),
        cam_frames=np.asarray([f for (f, _) in cam_list], np.int64),
        cam_ids=np.asarray([c for (_, c) in cam_list], np.int64),
        poses=np.stack([np.asarray(pipe.cameras[f]) for f in cam_list])
        if cam_list else np.zeros((0, 7)),
        landmark_ids=np.asarray(lm_list, np.int64),
        inv_depth=np.asarray(
            [pipe.landmarks[t].inv_depth for t in lm_list], np.float64
        ),
        observations=obs,
        tracks=tracks,
    )


def load_map(path: str):
    """Returns (cameras dict, landmarks dict-of-dicts, tracks,
    outlier_tracks) in pipeline-native structures."""
    z = np.load(path, allow_pickle=False)
    header = json.loads(bytes(z["header"]).decode())
    assert header["version"] == 1
    cam_list = [
        (int(f), int(c)) for f, c in zip(z["cam_frames"], z["cam_ids"])
    ]
    cameras = {fcid: z["poses"][i] for i, fcid in enumerate(cam_list)}

    lm_ids = z["landmark_ids"]
    landmarks = {
        int(t): {"inv_depth": float(z["inv_depth"][i]), "obs": {},
                 "outlier_obs": {}}
        for i, t in enumerate(lm_ids)
    }
    for li, ci, feat, is_out in z["observations"]:
        t = int(lm_ids[li])
        key = "outlier_obs" if is_out else "obs"
        landmarks[t][key][cam_list[ci]] = int(feat)

    tracks: dict = {}
    outlier_tracks: dict = {}
    for t, f, c, feat, is_out in z["tracks"]:
        target = outlier_tracks if is_out else tracks
        target.setdefault(int(t), {})[(int(f), int(c))] = int(feat)
    return cameras, landmarks, tracks, outlier_tracks
