"""Calibration JSON input, the reference's cereal archive layout.

Copy of the loading half of ``photometric_bundle_adjustment_tpu/io/calib_io.py``
(numpy only): ``opt_calib.json`` holds ``Calibration { T_i_c, intrinsics
}`` with the polymorphic camera form (``cam_type``, ``fx..p4``, ``width``,
``height``), serialization.h:116-174, wrapped by cereal in ``{"value0":
...}`` with the C++ field names.
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
