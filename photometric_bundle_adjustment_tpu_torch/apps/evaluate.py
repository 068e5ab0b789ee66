"""Compare two saved maps: ATE after SE3/Sim3 alignment, stereo-baseline
consistency, and map statistics.

    python -m photometric_bundle_adjustment_tpu_torch.apps.evaluate \\
        --map map_a.pkl --ref map_b.pkl [--calib opt_calib.json]

Port of ``photometric_bundle_adjustment_tpu/apps/evaluate.py``, through
the port's ``utils/evaluation.py`` and ``io/map_io.py``: a map is the
pickle ``apps/sfm`` writes or, for a ``.npz`` path, a ``map_io`` file.
With only --map, prints that map's own statistics (stereo baseline
against the calibrated extrinsics, trajectory extent, landmark and
observation counts).  Host arithmetic only: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np


def load_map(path: str) -> dict:
    """A saved map as the pickle's dict (``cameras``, ``landmarks``, ...)."""
    if path.endswith(".npz"):
        from photometric_bundle_adjustment_tpu_torch.io import map_io

        cameras, landmarks, tracks, outlier_tracks = map_io.load_map(path)
        return {"cameras": cameras, "landmarks": landmarks,
                "tracks": tracks, "outlier_tracks": outlier_tracks}
    with open(path, "rb") as f:
        return pickle.load(f)


def stereo_baselines(cameras: dict) -> np.ndarray:
    """|t_1 - t_0| of every frame with both cameras: the length of the
    relative pose's translation."""
    frames = sorted({f for (f, c) in cameras})
    return np.asarray([
        float(np.linalg.norm(np.asarray(cameras[(f, 1)])[:3]
                             - np.asarray(cameras[(f, 0)])[:3]))
        for f in frames if (f, 0) in cameras and (f, 1) in cameras])


def main(argv=None):
    parser = argparse.ArgumentParser(description="Map evaluation")
    parser.add_argument("--map", required=True, help="map to evaluate")
    parser.add_argument("--ref", default=None,
                        help="reference map for ATE comparison")
    parser.add_argument("--calib", default=None,
                        help="calibration JSON (for the baseline target)")
    parser.add_argument("--with-scale", action="store_true",
                        help="Sim3 (scale-corrected) alignment for ATE")
    args = parser.parse_args(argv)

    from photometric_bundle_adjustment_tpu_torch.utils import evaluation

    m = load_map(args.map)
    cams = m["cameras"]

    def obs_of(lm):
        return lm["obs"] if isinstance(lm, dict) else lm.obs

    out = {
        "cameras": len(cams),
        "landmarks": len(m.get("landmarks", {})),
        "observations": sum(
            len(obs_of(lm)) for lm in m.get("landmarks", {}).values()
        ) if m.get("landmarks") else None,
    }
    ps = np.stack([np.asarray(T)[:3] for T in cams.values()])
    ext = ps.max(0) - ps.min(0)
    out["trajectory_extent_m"] = [round(float(x), 3) for x in ext]

    bl = stereo_baselines(cams)
    if len(bl):
        out["stereo_baseline_median_m"] = round(float(np.median(bl)), 4)
        out["stereo_baseline_std_m"] = round(float(bl.std()), 4)
    if args.calib:
        from photometric_bundle_adjustment_tpu_torch.io import calib_io

        calib = calib_io.load_calibration(args.calib)
        t = np.asarray(calib.T_i_c[1])[:3] - np.asarray(calib.T_i_c[0])[:3]
        out["stereo_baseline_calibrated_m"] = round(
            float(np.linalg.norm(t)), 4)

    if args.ref:
        ref = load_map(args.ref)
        shared = sorted(set(cams) & set(ref["cameras"]))
        out["shared_cameras"] = len(shared)
        if len(shared) >= 3:
            est = np.stack([np.asarray(cams[f])[:3] for f in shared])
            gt = np.stack([np.asarray(ref["cameras"][f])[:3]
                           for f in shared])
            out["ate_rmse_m"] = round(
                evaluation.ate_rmse(est, gt, with_scale=args.with_scale), 4)
            s, R, t = evaluation.umeyama_alignment(
                est, gt, with_scale=args.with_scale)
            aligned = (s * (R @ est.T)).T + t
            err = np.linalg.norm(aligned - gt, axis=1)
            out["ate_median_m"] = round(float(np.median(err)), 4)
            out["ate_p95_m"] = round(float(np.percentile(err, 95)), 4)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
