"""Photometric bundle adjustment app (the pba2 capability): geometric SfM,
then a photometric refinement of the map with direct intensity-patch
residuals.

    python -m photometric_bundle_adjustment_tpu_torch.apps.pba \\
        --dataset-path /path/to/euroc_V1 --cam-calib opt_calib.json \\
        [--map-in map.pkl] [--device cuda|cpu]

Port of ``photometric_bundle_adjustment_tpu/apps/pba.py``.  With
``--map-in`` it refines a saved geometric map (``apps/sfm``'s pickle of
either package): the corners are loaded from ``--cache-dir`` or detected
again (detection is deterministic, so they carry the feature ids the
saved observations name); without it, ``SfmPipeline.run`` builds the map
first.  ``refine_map`` then runs ``pipeline/pba_refine.refine_photometric``
on ``--device`` (the card by default) and the app writes the JAX
package's pickle with the per-image affine brightness.  ``--distributed
D`` solves the full-resolution problem instead on D ranks of the
landmark-sharded solver (``refine_photometric_distributed``), on the card
by default (D > 1 ranks share one card under Gloo; NCCL where each rank
has its own), prints its agreement with the single-device solve and
writes the distributed solution.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time


def refine_map(pipe, *, iterations: int = 20, huber: float = 9.0,
               levels: int = 3, sample_bf16: bool = False, log=print,
               device="cuda") -> list:
    """Refine the map held by ``pipe`` photometrically on ``device``
    (``apps/pba``'s defaults: 3 levels, 20 iterations, Huber 9, f32) and
    return the per-level stats (``pipe.photometric_levels``: size, initial
    and final cost, iterations, tries, set-up and solve seconds)."""
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    pba_refine.refine_photometric(
        pipe, max_iterations=iterations, huber_delta=huber, levels=levels,
        sample_bf16=sample_bf16, log=log, device=device)
    return pipe.photometric_levels


def main(argv=None):
    parser = argparse.ArgumentParser(description="Photometric bundle adjustment")
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--cam-calib", default="opt_calib.json")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--show-gui", default="false",
                        help="Accepted for CLI parity; this app is headless.")
    parser.add_argument("--cache-dir", default=None)
    parser.add_argument("--map-out", default="map_pba.pkl")
    parser.add_argument(
        "--map-in", default=None,
        help="geometric map pickle (from apps.sfm) to refine directly, "
             "skipping the geometric SfM run (keypoints are re-detected "
             "deterministically to recover the anchor patches)")
    parser.add_argument("--pba-iterations", type=int, default=20)
    parser.add_argument(
        "--sample-bf16", action="store_true",
        help="sample a bf16 copy of the images in the megakernel (uint8 "
             "intensities exact; arithmetic in f32)")
    parser.add_argument("--huber-intensity", type=float, default=9.0)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument(
        "--distributed", type=int, default=0, metavar="D",
        help="solve on D ranks of the landmark-sharded solver "
             "(parallel/dist_fused.py) at full resolution, cross-checked "
             "against the single-device solve")
    args = parser.parse_args(argv)

    from photometric_bundle_adjustment_tpu_torch import device as devices
    from photometric_bundle_adjustment_tpu_torch.io import calib_io, dataset
    from photometric_bundle_adjustment_tpu_torch.pipeline.config import (
        SfmConfig,
    )
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        Landmark,
        SfmPipeline,
    )

    devices.resolve(args.device)
    if not os.path.exists(args.cam_calib):
        parser.error(f"could not load camera calibration {args.cam_calib}")
    images, timestamps = dataset.load_images(args.dataset_path,
                                             args.max_frames)
    print(f"Loaded {len(timestamps)} image pairs")
    calib = calib_io.load_calibration(args.cam_calib)

    pipe = SfmPipeline(images, calib, SfmConfig(), cache_dir=args.cache_dir,
                       device=args.device)
    t0 = time.time()
    if args.map_in:
        with open(args.map_in, "rb") as f:
            m = pickle.load(f)
        # detection is deterministic, so recomputed corners carry the
        # feature ids the saved observations name
        if not pipe._load_cache("corners"):
            pipe.detect_keypoints()
        pipe.cameras = dict(m["cameras"])
        pipe.tracks = dict(m.get("tracks", {}))
        pipe.landmarks = {
            t: Landmark(d["inv_depth"], dict(d["obs"]),
                        dict(d.get("outlier_obs", {})))
            for t, d in m["landmarks"].items()}
        print(f"Loaded geometric map from {args.map_in}: {pipe.summary()}")
    else:
        pipe.run()
        print(f"Geometric SfM done in {time.time() - t0:.1f}s: "
              f"{pipe.summary()}")

    if args.distributed:
        from photometric_bundle_adjustment_tpu_torch.pipeline import (
            pba_refine,
        )

        _, parity = pba_refine.refine_photometric_distributed(
            pipe, n_ranks=args.distributed,
            max_iterations=args.pba_iterations,
            huber_delta=args.huber_intensity, device=args.device)
        print(f"Distributed-vs-single parity: {parity}")
    else:
        refine_map(pipe, iterations=args.pba_iterations,
                   huber=args.huber_intensity, sample_bf16=args.sample_bf16,
                   device=args.device)
    with open(args.map_out, "wb") as f:
        pickle.dump({
            "cameras": pipe.cameras,
            "affine": getattr(pipe, "photometric_affine", {}),
            "landmarks": {
                t: {"inv_depth": lm.inv_depth, "obs": lm.obs,
                    "outlier_obs": lm.outlier_obs}
                for t, lm in pipe.landmarks.items()},
            "timestamps": timestamps,
        }, f)
    print(f"Saved photometric map as {args.map_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
