"""One SfM run from images to a finished map on the indoor room.

    python -m photometric_bundle_adjustment_tpu_torch.scripts.sfm_run \\
        [--frames 82] [--device cuda|cpu] [--global-init] [--quiet]

Renders ``synthetic.synth_stereo_sequence(room_radius=INDOOR_ROOM_RADIUS)``
(480x752, seed 0) and runs ``SfmPipeline.run`` with the default
``SfmConfig`` on ``--device`` (the card by default), or with
``--global-init`` ``apps/sfm``'s averaging bootstrap
(``apps.sfm.run_global_init``), then prints the stage times, the
counters, the map's size, the cam-0 trajectory's ATE against the rendered
poses after an SE3 alignment (the stereo baseline fixes the scale) and the
final map's reprojection RMS; the last line is one JSON object of these.
``chip_smoke.py`` phases 9 and 11 run the same scene through
``measure``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def measure(pipe, seq) -> dict:
    """The finished map against the rendered scene: images registered,
    map size, cam-0 ATE (m, SE3 alignment) and the reprojection RMS (px)
    of the inlier observations."""
    from photometric_bundle_adjustment_tpu_torch.utils import evaluation

    frames = sorted(f for f, c in pipe.cameras if c == 0)
    est = evaluation.trajectory_from_cameras(pipe.cameras)
    gt = np.stack([seq.poses_gt[(f, 0)][:3] for f in frames])
    proj = pipe.compute_projections()
    rms = None
    if proj is not None:
        rows, err, _ = proj
        inl = ~np.fromiter((r[3] for r in rows), bool, len(rows))
        rms = float(np.sqrt(np.mean(err[inl] ** 2)))
    return {
        "images": len(seq.images),
        "cameras": len(pipe.cameras),
        "landmarks": len(pipe.landmarks),
        "observations": sum(len(lm.obs) for lm in pipe.landmarks.values()),
        "outlier_tracks": len(pipe.outlier_tracks),
        "ate_m": evaluation.ate_rmse(est, gt, with_scale=False),
        "cam0_frames": len(frames),
        "rms_px": rms,
    }


def main(argv=None) -> dict:
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=82)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--global-init", action="store_true",
                    help="bootstrap by rotation and translation averaging "
                         "(apps/sfm --global-init)")
    ap.add_argument("--quiet", action="store_true",
                    help="print no pipeline log lines")
    args = ap.parse_args(argv)

    seq = synthetic.synth_stereo_sequence(
        n_frames=args.frames, room_radius=synthetic.INDOOR_ROOM_RADIUS,
        device=args.device)
    pipe = SfmPipeline(seq.images, seq.calib, device=args.device,
                       log=(lambda *a: None) if args.quiet else print)
    t0 = time.perf_counter()
    if args.global_init:
        from photometric_bundle_adjustment_tpu_torch.apps.sfm import (
            run_global_init,
        )

        run_global_init(pipe)
    else:
        pipe.run()
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    wall = time.perf_counter() - t0
    out = measure(pipe, seq)
    out.update(
        frames=args.frames, device=str(pipe.device),
        global_init=args.global_init, wall_s=wall,
        keyframes_per_s=args.frames / wall,
        device_s=pipe.device_seconds,
        timings_s=dict(pipe.timings), timings_dev_s=dict(pipe.timings_dev),
        counters=dict(sorted(pipe.counters.items())),
        summary=pipe.summary())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
