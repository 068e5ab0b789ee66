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
  * splits ``SfmPipeline.match_all`` (the worklist's matching and its
    five-point RANSAC, 128 hypotheses a pair, f64): the Hamming match and
    the compaction above, then, on the pipeline's first RANSAC chunk (the
    pairs of the most matches), the sampling, the five-point solve, the prescreen
    (with the decomposition of its best candidates), the scoring, the LM
    refinement and the final inlier selection, and the host's consume
    loop over the chunk (the fetch in one copy included), each the
    median of ``--reps`` warm calls to a device sync; and the whole
    ``match_all``, the median of ``min(reps, 3)`` calls, once more under
    ``torch.profiler``;
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
    nister,
    pair_matching,
    ransac,
)
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.ops import hamming
from photometric_bundle_adjustment_tpu_torch.optim.ba import full_f32
from photometric_bundle_adjustment_tpu_torch.pipeline import sfm_pipeline
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
    ransac_ms, match_all_ms, (chunk_pairs, chunk_cols), chunks = _match_all_split(
        pipe, table, ids, device, reps)
    match_all_run, _, _ = _synced(pipe.match_all, device, 1)
    prof_detect = profile_run(detect_run, 1, device)
    prof_stereo = profile_run(stereo_run, 1, device)
    prof_pairs = profile_run(pairs_run, 1, device)
    prof_all = profile_run(match_all_run, 1, device)
    result = dict(
        device=torch.cuda.get_device_name(device) if gpu else "cpu",
        images=len(pipe.fcids), H=args.H, W=args.W, pairs=len(ids),
        F=int(desc.shape[1]), reps=args.reps, **stages_ms,
        match_pairs_hamming_launches=launches, **batch_ms,
        hypotheses=cfg.ransac_hypotheses, ransac_chunk_pairs=chunk_pairs,
        ransac_chunk_columns=chunk_cols,
        ransac_chunks=chunks, match_all_ms=match_all_ms,
        match_all_pairs_per_s=1e3 * len(ids) / match_all_ms,
        ransac_chunk_ms=ransac_ms,
        detect_profile=prof_detect, match_stereo_profile=prof_stereo,
        match_pairs_profile=prof_pairs, match_all_profile=prof_all,
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
    print(f"  match_all {match_all_ms:.3f} ms ({1e3 * len(ids) / match_all_ms:.1f}"
          f" pairs/s; {chunks} RANSAC chunks, {cfg.ransac_hypotheses} "
          f"hypotheses);"
          f" the first chunk's stages ({chunk_pairs} pairs, {chunk_cols} "
          f"columns):")
    for k, v in ransac_ms.items():
        print(f"    {k} {v:.4f} (median of {reps} calls, to a device sync)")
    for name, p in (("detect_keypoints", prof_detect),
                    ("match_stereo", prof_stereo),
                    ("match_pairs", prof_pairs),
                    ("match_all", prof_all)):
        print(f"  {name} under the profiler: wall {p['wall_ms']:.3f} ms"
              + (f", device busy {p['device_busy_ms']:.3f} ms "
                 f"({100 * p['device_busy_share']:.1f}%), "
                 f"{p['device_kernels_per_run']:.0f} device kernels"
                 if gpu else ""))
        for op, (count, t) in p["top_self_ms"].items():
            print(f"    {op}: {t:.3f} ms over {count} calls ({p['top_by']})")
    print(json.dumps(result))
    return result


def _match_all_split(pipe, table, ids, device, reps):
    """The stages of ``match_all``'s first RANSAC chunk, each the median of
    ``reps`` calls to a device sync (ms), and the whole ``match_all``
    (median of min(reps, 3) calls).  Returns (stage ms, match_all ms,
    pairs per chunk, chunks)."""
    cfg = pipe.cfg
    _, _, _, bear = pipe._stack_features()
    pairs, pvalid, count = match.matches_to_pairs(table,
                                                  cfg.max_matches_per_pair)
    plan = pipe._ransac_chunks(count.cpu().numpy(), pairs.shape[1],
                               bear.element_size())
    sel, Mc = plan[0]
    sd = torch.as_tensor(sel, device=device)
    i1 = torch.as_tensor(ids[sel, 0], device=device)
    i2 = torch.as_tensor(ids[sel, 1], device=device)
    pairs, count, pv = pairs[sd, :Mc], count[sd], pvalid[sd, :Mc]
    b0 = bear[i1[:, None], pairs[..., 0].long()]
    b1 = bear[i2[:, None], pairs[..., 1].long()]
    thr = cfg.relative_pose_ransac_thresh
    H = cfg.ransac_hypotheses
    out = {}

    def stage(name, fn):
        with full_f32():
            _, res, out[name] = _synced(fn, device, reps)
        return res

    idx = stage("sample_ms", lambda: ransac._sample_indices(
        pipe.generator, H, 5, pv))
    Es, ev = stage("five_point_ms", lambda: nister.five_point_candidates(
        ransac._gather_rows(b0, idx), ransac._gather_rows(b1, idx)))
    poses = stage("prescreen_ms", lambda: ransac._prescreen(b0, b1, pv, Es,
                                                            ev))
    T_best, inl = stage("score_ms", lambda: ransac._best_relative(
        b0, b1, pv, poses, thr))
    T = stage("refine_ms", lambda: ransac._refine_relative(b0, b1, inl,
                                                           T_best, 10))
    inliers = stage("inliers_ms", lambda: ransac._relative_inliers(
        b0, b1, pv, T[:, None, None], thr)[:, 0])
    chunk = [tuple(x) for x in ids[sel].tolist()]
    stage("consume_ms", lambda: pipe._consume(chunk, list(zip(
        *sfm_pipeline._fetch(pairs, count, T, inliers)))))
    _, _, all_ms = _synced(pipe.match_all, device, min(reps, 3))
    return out, all_ms, (len(sel), Mc), len(plan)


if __name__ == "__main__":
    main()
