"""Freeze the real EuRoC V1 map's geometric BA problem into an ``.npz``.

    python3 -m benchmark.tools.freeze_v1map [--out benchmark/data/v1map.npz]

Reads three committed files with plain pickle, json and numpy: the map
``runs/map_r5_run20.pkl`` (an SfM run on the real V1 images: cameras,
landmarks with their inverse depths and observations), the detection
cache ``runs/cache_r5/corners.pkl`` (the pixel of every feature id the
observations name) and the calibration
``refbaseline/artifacts/ref_opt_calib.json`` (the two double-sphere
cameras).  The problem is laid out as SfM builds it for a BA solve:
cameras sorted by (frame, cam), frame 0's two cameras fixed (the gauge);
landmarks sorted by track id, each anchored at its first observation in
(frame, cam) order, which gives the anchor pixel and contributes no row;
one row per other observation, landmark by landmark, in (frame, cam)
order.  Intrinsics are stored once per camera type and indexed per row.
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
MAP = ROOT / "runs" / "map_r5_run20.pkl"
CORNERS = ROOT / "runs" / "cache_r5" / "corners.pkl"
CALIB = ROOT / "refbaseline" / "artifacts" / "ref_opt_calib.json"
OUT = ROOT / "benchmark" / "data" / "v1map.npz"


def problem_arrays(map_dict: dict, corners: dict, calib: dict) -> dict:
    """The map's BA problem as a dict of numpy arrays (the ``.npz``'s
    contents)."""
    cams = calib["cam.intrinsics"]
    types = {c["cam_type"] for c in cams}
    if len(types) != 1:
        raise ValueError(f"one camera model expected, got {sorted(types)}")
    intrinsics = np.array([[c[k] for k in ("fx", "fy", "cx", "cy", "p1",
                                           "p2", "p3", "p4")] for c in cams],
                          np.float64)
    cam_list = sorted(map_dict["cameras"])
    cam_index = {f: i for i, f in enumerate(cam_list)}
    lm_list = sorted(map_dict["landmarks"])
    poses = np.stack([np.asarray(map_dict["cameras"][f], np.float64)
                      for f in cam_list])
    rho = np.zeros(len(lm_list))
    an, tc, lm, uv_t, uv_r, ia, it = [], [], [], [], [], [], []
    for j, t in enumerate(lm_list):
        d = map_dict["landmarks"][t]
        obs = sorted(d["obs"].items())
        rho[j] = d["inv_depth"]
        (fa, feat_a), rest = obs[0], obs[1:]
        uv_a = corners[fa]["uv"][feat_a]
        for fc, feat in rest:
            an.append(cam_index[fa])
            tc.append(cam_index[fc])
            lm.append(j)
            uv_t.append(corners[fc]["uv"][feat])
            uv_r.append(uv_a)
            ia.append(fa[1])
            it.append(fc[1])
    fixed = np.array([f in ((0, 0), (0, 1)) for f in cam_list])
    return dict(
        model=np.array(types.pop()), poses=poses, inv_depth=rho,
        anchor_cam=np.array(an, np.int32), target_cam=np.array(tc, np.int32),
        landmark=np.array(lm, np.int32),
        uv_target=np.array(uv_t, np.float64).reshape(-1, 2),
        uv_ref=np.array(uv_r, np.float64).reshape(-1, 2),
        intr_ref=np.array(ia, np.int8), intr_target=np.array(it, np.int8),
        intrinsics=intrinsics, fixed=fixed,
        frame_cam=np.array(cam_list, np.int32))


def load_inputs():
    with open(MAP, "rb") as f:
        map_dict = pickle.load(f)
    with open(CORNERS, "rb") as f:
        corners = pickle.load(f)["data"]
    with open(CALIB) as f:
        calib = json.load(f)["value0"]
    return map_dict, corners, calib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    arrays = problem_arrays(*load_inputs())
    np.savez_compressed(args.out, **arrays)
    print(f"{args.out}: {arrays['poses'].shape[0]} cameras, "
          f"{arrays['inv_depth'].shape[0]} landmarks, "
          f"{arrays['landmark'].shape[0]} observations")


if __name__ == "__main__":
    main()
