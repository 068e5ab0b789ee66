"""Where the time of the SfM front end goes, at EuRoC V1's size.

    python3 -m photometric_bundle_adjustment_tpu_torch.profile_frontend

Renders the stereo sequence ``chip_smoke.py`` drives (82 stereo frames,
164 images of 480x752, seed 0), runs the front end once to warm up, and
then:

  * times each stage to a device sync on the host clock, the median of
    ``--reps`` warm calls: ``SfmPipeline.detect_keypoints``,
    ``match_stereo`` and ``pair_matching.match_pairs`` over the
    13,284-pair worklist (with the Hamming kernel launches a call makes:
    one, for both match directions), and its compaction
    ``match.matches_to_pairs`` on the device;
  * times the pieces of one detection batch of 8 images, mean of
    ``--reps`` calls (CUDA events on a GPU, the host clock on the CPU):
    ``shi_tomasi_score``, ``detect_keypoints``, ``compute_angles`` and
    ``compute_descriptors``;
  * runs ``detect_keypoints``, ``match_stereo`` and the all-pairs match
    once each under ``torch.profiler``: wall time, device busy time and share, device
    kernels, and the operators with the largest device self time;
  * reports the peak device memory.

Prints one JSON object with every number as its last line.  ``--device
cpu`` with small ``--frames/--H/--W`` runs the same code on the plain
path.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.features import (
    describe,
    detect,
    match,
    pair_matching,
)
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.ops import hamming
from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
    SfmPipeline,
)
from photometric_bundle_adjustment_tpu_torch.profile_solve import (
    SEED,
    profile_run,
    time_ms,
)

BATCH = 8


def _synced(fn, device: torch.device, reps: int):
    """``fn`` followed by a device sync; the output of its last call and
    the median wall milliseconds of ``reps`` calls."""
    def run():
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        times.append(1e3 * (time.perf_counter() - t0))
    return run, out, float(np.median(times))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=82)
    ap.add_argument("--H", type=int, default=480)
    ap.add_argument("--W", type=int, default=752)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    device = devices.resolve(args.device)
    gpu = device.type == "cuda"

    seq = synthetic.synth_stereo_sequence(n_frames=args.frames, H=args.H,
                                          W=args.W, seed=SEED, device=device)
    pipe = SfmPipeline(seq.images, seq.calib, log=lambda s: None,
                       device=device)
    cfg = pipe.cfg
    pipe.detect_keypoints()                    # warm-up
    pipe.match_stereo()
    ids = np.array(pipe._pair_worklist())
    if gpu:
        torch.cuda.reset_peak_memory_stats(device)
    _, valid, desc, _ = pipe._stack_features()

    def all_pairs():
        return pair_matching.match_pairs(
            desc, valid, ids[:, 0], ids[:, 1], cfg.feature_match_max_dist,
            cfg.feature_match_test_next_best)

    reps = args.reps
    detect_run, _, detect_ms = _synced(pipe.detect_keypoints, device, reps)
    stereo_run, _, stereo_ms = _synced(pipe.match_stereo, device, reps)
    launches = hamming.KERNEL_LAUNCHES
    pairs_run, table, pairs_ms = _synced(all_pairs, device, reps)
    launches = (hamming.KERNEL_LAUNCHES - launches) / reps
    _, _, compact_ms = _synced(
        lambda: match.matches_to_pairs(table, cfg.max_matches_per_pair),
        device, reps)
    stages_ms = dict(detect_ms=detect_ms, match_stereo_ms=stereo_ms,
                     match_pairs_ms=pairs_ms, compact_ms=compact_ms)

    imgs = torch.as_tensor(np.stack([seq.images[k]
                                     for k in pipe.fcids[:BATCH]]),
                           device=device)
    F = cfg.num_features_per_image
    uv, _, _ = detect.detect_keypoints(imgs, num_features=F)
    angles = describe.compute_angles(imgs, uv)

    def ms(fn):
        return time_ms(fn, device, args.reps)

    batch_ms = dict(
        batch_ms=ms(lambda: describe.detect_and_describe_batch(imgs, F)),
        shi_tomasi_ms=ms(lambda: detect.shi_tomasi_score(imgs)),
        detect_keypoints_ms=ms(lambda: detect.detect_keypoints(
            imgs, num_features=F)),
        compute_angles_ms=ms(lambda: describe.compute_angles(imgs, uv)),
        compute_descriptors_ms=ms(lambda: describe.compute_descriptors(
            imgs, uv, angles)),
    )
    prof_detect = profile_run(detect_run, 1, device)
    prof_stereo = profile_run(stereo_run, 1, device)
    prof_pairs = profile_run(pairs_run, 1, device)
    result = dict(
        device=torch.cuda.get_device_name(device) if gpu else "cpu",
        images=len(pipe.fcids), H=args.H, W=args.W, pairs=len(ids),
        F=int(desc.shape[1]), reps=args.reps, **stages_ms,
        match_pairs_hamming_launches=launches, **batch_ms,
        detect_profile=prof_detect, match_stereo_profile=prof_stereo,
        match_pairs_profile=prof_pairs,
        peak_device_mib=(torch.cuda.max_memory_allocated(device) / 2**20
                         if gpu else None),
    )
    print(f"profile_frontend: {result['device']}, {result['images']} images "
          f"of {args.H}x{args.W}, {result['pairs']} pairs at F={result['F']}")
    for k, v in stages_ms.items():
        print(f"  {k} {v:.4f} (median of {reps} calls, to a device sync)")
    print(f"  Hamming kernel launches per match_pairs call: {launches:g}")
    for k, v in batch_ms.items():
        print(f"  {k} {v:.4f} (batch of {BATCH}, mean of {args.reps})")
    for name, p in (("detect_keypoints", prof_detect),
                    ("match_stereo", prof_stereo),
                    ("match_pairs", prof_pairs)):
        print(f"  {name} under the profiler: wall {p['wall_ms']:.3f} ms"
              + (f", device busy {p['device_busy_ms']:.3f} ms "
                 f"({100 * p['device_busy_share']:.1f}%), "
                 f"{p['device_kernels_per_run']:.0f} device kernels"
                 if gpu else ""))
        for op, (count, t) in p["top_self_ms"].items():
            print(f"    {op}: {t:.3f} ms over {count} calls ({p['top_by']})")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
