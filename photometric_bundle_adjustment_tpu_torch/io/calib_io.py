"""Calibration and calibration-dataset JSON, the reference's cereal
archive layout.

Copy of ``photometric_bundle_adjustment_tpu/io/calib_io.py`` (numpy
only).  The reference persists:

* ``opt_calib.json``: ``Calibration { T_i_c, intrinsics }`` with the
  polymorphic camera form (``cam_type``, ``fx..p4``, ``width``,
  ``height``), serialization.h:116-174, written by calibration.cpp:430-439
  and read by sfm.cpp:933-957;
* ``calibration-double-sphere.json``: double-sphere intrinsics (``fx, fy,
  cx, cy, xi, alpha``), serialization.h:92-113, read by
  calibration.cpp:279-302;
* ``init_poses.json`` and ``detected_corners.json``: maps keyed by
  FrameCamId with cereal's positional ``value0/value1/...`` names,
  serialization.h:145-153.

cereal wraps the archive root in ``{"value0": ...}`` and keeps the C++
field names (``cam.T_i_c`` etc.), so a file written by either package or
by the reference reads in the others.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np


def pose_from_json(d: dict) -> np.ndarray:
    """A cereal pose object as (7,) [tx, ty, tz, qx, qy, qz, qw]."""
    return np.array(
        [d["px"], d["py"], d["pz"], d["qx"], d["qy"], d["qz"], d["qw"]],
        np.float64,
    )


def pose_to_json(p) -> dict:
    p = np.asarray(p, np.float64)
    return {
        "px": float(p[0]), "py": float(p[1]), "pz": float(p[2]),
        "qx": float(p[3]), "qy": float(p[4]), "qz": float(p[5]),
        "qw": float(p[6]),
    }


@dataclass
class Calibration:
    """Mirror of visnav::Calibration (include/visnav/calibration.h:83-93):
    per-camera extrinsics T_i_c (camera-to-IMU) and intrinsics."""

    T_i_c: np.ndarray                    # (num_cams, 7)
    intrinsics: np.ndarray               # (num_cams, 8)
    cam_types: list = field(default_factory=list)   # model name per cam
    widths: list = field(default_factory=list)
    heights: list = field(default_factory=list)

    @property
    def num_cams(self) -> int:
        return self.T_i_c.shape[0]


def load_calibration(path: str) -> Calibration:
    """Load the polymorphic-camera form (opt_calib.json)."""
    with open(path) as f:
        root = json.load(f)["value0"]
    T_i_c = np.stack([pose_from_json(p) for p in root["cam.T_i_c"]])
    intr, types, ws, hs = [], [], [], []
    for c in root["cam.intrinsics"]:
        intr.append([c["fx"], c["fy"], c["cx"], c["cy"],
                     c["p1"], c["p2"], c["p3"], c["p4"]])
        types.append(c["cam_type"])
        ws.append(int(c.get("width", 0)))
        hs.append(int(c.get("height", 0)))
    return Calibration(T_i_c, np.array(intr, np.float64), types, ws, hs)


def save_calibration(path: str, calib: Calibration) -> None:
    """Write ``calib`` in the polymorphic-camera form (opt_calib.json)."""
    root = {
        "cam.T_i_c": [pose_to_json(p) for p in calib.T_i_c],
        "cam.intrinsics": [
            {
                "cam_type": calib.cam_types[i],
                **{k: float(calib.intrinsics[i][j]) for j, k in enumerate(
                    ("fx", "fy", "cx", "cy", "p1", "p2", "p3", "p4"))},
                "width": int(calib.widths[i]) if calib.widths else 0,
                "height": int(calib.heights[i]) if calib.heights else 0,
            }
            for i in range(calib.num_cams)
        ],
    }
    with open(path, "w") as f:
        json.dump({"value0": root}, f, indent=4)


def load_ds_calibration(path: str) -> Calibration:
    """Load the double-sphere initialisation form
    (calibration-double-sphere.json; extra IMU fields ignored)."""
    with open(path) as f:
        root = json.load(f)["value0"]
    T_i_c = np.stack([pose_from_json(p) for p in root["cam.T_i_c"]])
    intr = [[c["fx"], c["fy"], c["cx"], c["cy"], c["xi"], c["alpha"], 0.0,
             0.0] for c in root["cam.intrinsics"]]
    return Calibration(T_i_c, np.array(intr, np.float64), ["ds"] * len(intr))


def _fcid_key(entry: dict) -> tuple:
    return (int(entry["key"]["first"]), int(entry["key"]["second"]))


def load_detected_corners(path: str) -> dict:
    """{(frame, cam): {"corners": (N, 2), "corner_ids": (N,)}} from
    detected_corners.json (CalibCornerData, serialization.h:145-148)."""
    with open(path) as f:
        root = json.load(f)["value0"]
    out = {}
    for entry in root:
        v = entry["value"]
        corners = np.array(
            [[c["value0"], c["value1"]] for c in v["value0"]], np.float64
        ).reshape(-1, 2)
        ids = np.array(v["value1"], np.int32)
        out[_fcid_key(entry)] = {"corners": corners, "corner_ids": ids}
    return out


def load_init_poses(path: str) -> dict:
    """{(frame, cam): T_a_c (7,)} from init_poses.json
    (CalibInitPoseData, serialization.h:150-153)."""
    with open(path) as f:
        root = json.load(f)["value0"]
    return {_fcid_key(e): pose_from_json(e["value"]["value0"]) for e in root}
