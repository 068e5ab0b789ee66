"""Incremental stereo SfM app (reference: src/sfm.cpp, headless mode).

    python -m photometric_bundle_adjustment_tpu_torch.apps.sfm \\
        --dataset-path /path/to/euroc_V1 --cam-calib opt_calib.json \\
        --max-frames 0 [--device cuda|cpu]

Port of ``photometric_bundle_adjustment_tpu/apps/sfm.py``: runs the staged
pipeline to completion (next_step loop, sfm.cpp:472-478) on ``--device``
(the card by default), prints the reference's progress counters, writes
the run's stats record (``--stats-out``, by default
``runs/last_run_stats_torch.json``: wall time, per-stage wall and
device-block seconds, the pipeline's counters, the device and its
``backend``, "cuda" or "cpu"; the port's ``bench.py`` reads it) and saves
the map as the JAX package's pickle or, for a ``.cereal`` path, the
reference's binary archive.  ``--global-init`` replaces the incremental
bootstrap by rotation and translation averaging over the match graph
(``pipeline/global_init``, through ``run_global_init``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

# the port's own record (bench.py's --stats default): the JAX package's
# apps.sfm writes runs/last_run_stats.json, the committed record of its
# TPU run, which this app must not overwrite
STATS_OUT = "runs/last_run_stats_torch.json"


def run_global_init(pipe) -> None:
    """``--global-init``'s run: step until the tracks exist, estimate every
    connected camera by averaging (``global_init.global_initialize``),
    then BA and the rest of ``run`` from ``Stage.OPTIMIZE``."""
    from photometric_bundle_adjustment_tpu_torch.pipeline import global_init
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        Stage,
    )

    while not pipe.tracks and pipe.next_step():
        pass
    global_init.global_initialize(pipe, log=pipe.log)
    pipe.stage = Stage.OPTIMIZE
    pipe.run()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Incremental stereo SfM")
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--voc-path", default="",
                        help="a bag-of-words vocabulary (BowVocabulary.load) "
                             "for match_bow; all pairs are matched without "
                             "one")
    parser.add_argument("--cam-calib", default="opt_calib.json")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--show-gui", default="false",
                        help="Accepted for CLI parity; this app is headless.")
    parser.add_argument("--cache-dir", default=None)
    parser.add_argument("--map-out", default="map.pkl")
    parser.add_argument(
        "--stats-out", default=STATS_OUT,
        help="write a JSON record of wall time, per-stage timings and the "
             "pipeline's counters ('' disables)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--optimize-intrinsics", action="store_true",
        help="Refine shared camera intrinsics during BA "
             "(the reference's optimize_intrinsics option)")
    parser.add_argument(
        "--params-file", default=None,
        help="JSON file of SfmConfig overrides, re-read before every "
             "pipeline step (the headless analog of the reference's "
             "live-tunable parameter panel, sfm.cpp:197-261)")
    parser.add_argument(
        "--global-init", action="store_true",
        help="initialise every connected camera at once by rotation and "
             "translation averaging over the match graph, then triangulate "
             "and run BA, instead of the incremental bootstrap")
    args = parser.parse_args(argv)

    if str(args.show_gui).lower() in ("true", "1", "yes"):
        print("[sfm] --show-gui requested but this app is headless; "
              "ignoring.")

    from photometric_bundle_adjustment_tpu_torch.io import calib_io, dataset
    from photometric_bundle_adjustment_tpu_torch.pipeline.config import (
        SfmConfig,
    )
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    if not os.path.exists(args.cam_calib):
        parser.error(f"could not load camera calibration {args.cam_calib}")
    images, timestamps = dataset.load_images(args.dataset_path,
                                             args.max_frames)
    print(f"Loaded {len(timestamps)} image pairs")
    calib = calib_io.load_calibration(args.cam_calib)
    print(f"Loaded camera from {args.cam_calib} with models "
          + " ".join(calib.cam_types))

    cfg = SfmConfig(use_match_bow=bool(args.voc_path),
                    ba_optimize_intrinsics=args.optimize_intrinsics)
    pipe = SfmPipeline(images, calib, cfg, seed=args.seed,
                       device=args.device, cache_dir=args.cache_dir,
                       params_file=args.params_file)
    if args.voc_path:
        from photometric_bundle_adjustment_tpu_torch.features import bow

        pipe.bow_voc = bow.BowVocabulary.load(args.voc_path)

    t0 = time.time()
    if args.global_init:
        run_global_init(pipe)
    else:
        pipe.run()
    wall = time.time() - t0
    print(pipe.summary())
    print("Timings: "
          + ", ".join(f"{k}={v:.2f}" for k, v in sorted(pipe.timings.items()))
          + f", total={wall:.2f}s")

    if args.stats_out:
        stats = {
            "n_images": len(images),
            "wall_s": round(wall, 3),
            # blocks that compute on the device and end in a host fetch,
            # and the rest (union-find, candidates, Python chunking)
            "device_s": round(pipe.device_seconds, 3),
            "host_s": round(wall - pipe.device_seconds, 3),
            "device": str(pipe.device),
            "backend": pipe.device.type,
            "timings_s": {k: round(v, 3)
                          for k, v in sorted(pipe.timings.items())},
            "timings_dev_s": {k: round(v, 3)
                              for k, v in sorted(pipe.timings_dev.items())},
            "counters": dict(sorted(pipe.counters.items())),
            "summary": pipe.summary(),
        }
        os.makedirs(os.path.dirname(args.stats_out) or ".", exist_ok=True)
        with open(args.stats_out, "w") as f:
            json.dump(stats, f, indent=1)
        print(f"Saved run stats as {args.stats_out}")

    n_obs = sum(len(lm.obs) for lm in pipe.landmarks.values())
    if args.map_out.endswith(".cereal"):
        # the reference-native binary map (map_utils.h:88-116)
        from photometric_bundle_adjustment_tpu_torch.io import cereal_io

        cereal_io.export_pipeline_map(pipe, args.map_out)
    else:
        with open(args.map_out, "wb") as f:
            pickle.dump({
                "cameras": pipe.cameras,
                "landmarks": {
                    t: {"inv_depth": lm.inv_depth, "obs": lm.obs,
                        "outlier_obs": lm.outlier_obs}
                    for t, lm in pipe.landmarks.items()},
                "tracks": pipe.tracks,
                "outlier_tracks": pipe.outlier_tracks,
                "timestamps": timestamps,
            }, f)
    print(f"Saved map as {args.map_out} ({len(pipe.cameras)} cameras, "
          f"{len(pipe.landmarks)} landmarks, {n_obs} observations)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
