"""Compare an SfM map against the reference binary's map.

    python -m photometric_bundle_adjustment_tpu_torch.scripts.compare_to_reference \\
        --ref-dump refbaseline/artifacts/run_v1_trajectory.txt \\
        --our-map map.pkl

Port of the JAX package's ``scripts/compare_to_reference.py``, through the
port's ``utils/evaluation.py`` and ``io/map_io.py``.  The reference map is
the text dump of refbaseline/bin/dump_map (``CAMERA frame cam tx ty tz qx
qy qz qw`` and ``LANDMARK ... n_obs n_outlier_obs`` lines); ours is the
pickle ``apps/sfm`` writes or a ``map_io`` file.  The two trajectories are
aligned with the Umeyama closed form; prints ATE-RMSE (SE3 and Sim3) and
the map-statistics table.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from photometric_bundle_adjustment_tpu_torch.io import map_io
from photometric_bundle_adjustment_tpu_torch.utils import evaluation


def parse_ref_dump(path: str):
    cams = {}
    landmarks = obs = out_obs = 0
    with open(path) as fh:
        for line in fh:
            f = line.split()
            if f[0] == "CAMERA":
                fcid = (int(f[1]), int(f[2]))
                cams[fcid] = np.array([float(x) for x in f[3:10]])
            elif f[0] == "LANDMARK":
                landmarks += 1
                obs += int(f[5])
                out_obs += int(f[6])
    return cams, {"cameras": len(cams), "landmarks": landmarks,
                  "observations": obs, "outlier_obs": out_obs}


def load_our_map(path: str) -> tuple[dict, dict]:
    """``(cameras, landmarks)`` of a map pickle (``.pkl``) or a ``map_io``
    file."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        return ({f: np.asarray(p) for f, p in blob["cameras"].items()},
                blob["landmarks"])
    cameras, landmarks, _, _ = map_io.load_map(path)
    return cameras, landmarks


def trajectory_ate(ref_cams: dict, cameras: dict) -> tuple[float, float]:
    """ATE-RMSE (m) of the cameras both maps hold, after an SE3 and after a
    Sim3 alignment of ours onto the reference."""
    shared = sorted(set(ref_cams) & set(cameras))
    ours = np.stack([np.asarray(cameras[f])[:3] for f in shared])
    ref = np.stack([ref_cams[f][:3] for f in shared])
    return (evaluation.ate_rmse(ours, ref, with_scale=False),
            evaluation.ate_rmse(ours, ref, with_scale=True))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-dump", required=True)
    ap.add_argument("--our-map", required=True)
    args = ap.parse_args(argv)

    ref_cams, ref_stats = parse_ref_dump(args.ref_dump)
    cameras, landmarks = load_our_map(args.our_map)
    our_stats = {
        "cameras": len(cameras),
        "landmarks": len(landmarks),
        "observations": sum(len(lm["obs"]) for lm in landmarks.values()),
        "outlier_obs": sum(len(lm["outlier_obs"])
                           for lm in landmarks.values()),
    }

    shared = sorted(set(ref_cams) & set(cameras))
    ref = np.stack([ref_cams[f][:3] for f in shared])
    ate, ate_s = trajectory_ate(ref_cams, cameras)

    print(f"{'':>16} {'reference':>10} {'ours':>10}")
    for k in ("cameras", "landmarks", "observations", "outlier_obs"):
        print(f"{k:>16} {ref_stats[k]:>10} {our_stats[k]:>10}")
    print(f"shared cameras: {len(shared)}")
    print(f"ATE-RMSE (SE3 align):  {ate * 100:.2f} cm")
    print(f"ATE-RMSE (Sim3 align): {ate_s * 100:.2f} cm")
    extent = ref.max(0) - ref.min(0)
    print(f"trajectory extent (ref): {extent[0]:.1f} x {extent[1]:.1f} x "
          f"{extent[2]:.1f} m")


if __name__ == "__main__":
    main()
