"""Photometric-BA value curve: an init-degradation ladder.

    python -m photometric_bundle_adjustment_tpu_torch.scripts.pba_value_curve \\
        --room [--frames 82] [--rungs 0,0.02,0.05,0.10,0.20] [--bf16] \\
        [--out runs/value_curve_torch.json] [--device cuda|cpu]
    python -m photometric_bundle_adjustment_tpu_torch.scripts.pba_value_curve \\
        --dataset-path <EuRoC V1 dir> [--map runs/map_r5_run12.pkl] \\
        [--cam-calib refbaseline/artifacts/ref_opt_calib.json] \\
        [--cache-dir runs/cache_r5] [...]

Port of the root ``scripts/pba_value_curve.py``.  A finished map's poses
are perturbed with increasing noise (``perturb_cameras``: σ_t of 0, 2, 5,
10 and 20 cm of translation and 0.1745 σ_t rad of rotation, the gauge pair
(0, 0), (0, 1) left alone), each rung is refined by
``pipeline/pba_refine.refine_photometric`` (20 iterations, Huber 9, 3
levels, f32 or ``--bf16``) from a copy of the unperturbed map, and both
trajectories are scored: the (SE3, Sim3) ATE in cm and the stereo
baselines' (median, std) (``stereo_baseline_stats``).

Two routes.  ``--room`` renders the indoor room
(``synthetic.synth_stereo_sequence(room_radius=INDOOR_ROOM_RADIUS)``),
maps it with ``SfmPipeline.run`` and scores against the rendered poses
(``room_score``).  The EuRoC route loads the images, the calibration, the
map and its corners (from ``--cache-dir`` or detected again) as the JAX
script does and scores against the reference binary's trajectory
(``score_ate`` on ``scripts/compare_to_reference``, in this process);
its images are not in the repository, so it needs ``--dataset-path``.

Every row has the JAX script's keys in its order, then the rung's
``seconds`` and per-level ``levels`` (``pipe.photometric_levels``).  The
rows go to ``--out`` with ``"backend": "torch"``, the device and the
card's name.  The JAX TPU run's records (``runs/value_curve*.json``,
``runs/vc_*.pkl``) are never written: an ``--out`` that holds another
run's record is refused, and no map pickle is written.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

RUNGS = "0,0.02,0.05,0.10,0.20"
GAUGE = ((0, 0), (0, 1))
REF_DUMP = "refbaseline/artifacts/run_v1_trajectory.txt"
OUT = "runs/value_curve_torch.json"


def perturb_cameras(cameras: dict, sigma_t: float, seed: int = 0) -> dict:
    """Gaussian pose noise: ``sigma_t`` m of translation and
    ``0.1745 sigma_t`` rad of axis-angle rotation (a right-plus tangent
    step, f64) on every camera but the gauge pair, drawn from numpy's
    ``default_rng(seed)`` in the dict's order.  Returns a new dict."""
    from photometric_bundle_adjustment_tpu_torch.core import se3

    rng = np.random.default_rng(seed)
    sigma_r = sigma_t * 0.1745  # ~10 deg per meter of translation noise
    out = {f: np.array(T, np.float64) for f, T in cameras.items()}
    moved = [f for f in out if f not in GAUGE] if sigma_t != 0.0 else []
    if moved:
        d = np.stack([np.concatenate([rng.normal(0, sigma_t, 3),
                                      rng.normal(0, sigma_r, 3)])
                      for _ in moved])
        T = se3.right_plus(torch.as_tensor(np.stack([out[f] for f in moved])),
                           torch.as_tensor(d)).numpy()
        out.update(zip(moved, T))
    return out


def stereo_baseline_stats(cameras: dict):
    """(median, std) of the stereo baselines (m), or None without a
    stereo pair."""
    from photometric_bundle_adjustment_tpu_torch.apps.evaluate import (
        stereo_baselines,
    )

    bl = stereo_baselines(cameras)
    if not len(bl):
        return None
    return float(np.median(bl)), float(np.std(bl))


def score_ate(map_or_path, ref_dump: str = REF_DUMP) -> tuple[float, float]:
    """The (SE3, Sim3) ATE-RMSE in cm of a map (a dict with ``cameras``, or
    a path ``compare_to_reference`` reads) against the reference binary's
    trajectory dump: the two numbers its report prints."""
    from photometric_bundle_adjustment_tpu_torch.scripts import (
        compare_to_reference as ctr,
    )

    cameras = (ctr.load_our_map(map_or_path)[0]
               if isinstance(map_or_path, str) else map_or_path["cameras"])
    ref_cams, _ = ctr.parse_ref_dump(ref_dump)
    se3_m, sim3_m = ctr.trajectory_ate(ref_cams, cameras)
    return se3_m * 100, sim3_m * 100


def room_score(seq):
    """``score(pipe)``: the (SE3, Sim3) ATE in cm of the cam-0 trajectory
    against the rendered poses of ``seq`` (SE3: ``sfm_run.measure``'s
    ``ate_m``)."""
    from photometric_bundle_adjustment_tpu_torch.utils import evaluation

    def score(pipe):
        frames = sorted(f for f, c in pipe.cameras if c == 0)
        est = evaluation.trajectory_from_cameras(pipe.cameras)
        gt = np.stack([seq.poses_gt[(f, 0)][:3] for f in frames])
        return (100 * evaluation.ate_rmse(est, gt, with_scale=False),
                100 * evaluation.ate_rmse(est, gt, with_scale=True))

    return score


def run_ladder(pipe, rungs, score, *, bf16: bool = False, device="cuda",
               max_iterations: int = 20, huber_delta: float = 9.0,
               levels: int = 3) -> list:
    """One row per rung (σ_t in m): ``pipe``'s map perturbed
    (``perturb_cameras``, from a copy of the unperturbed map each time),
    scored (``score(pipe)`` -> (SE3, Sim3) cm), refined
    (``refine_photometric`` on ``device``) and scored again.  The rows hold
    the JAX script's keys in its order, then ``seconds`` (the refinement's
    wall, to a device sync) and ``levels`` (``pipe.photometric_levels``).
    ``pipe`` ends holding the unperturbed map."""
    from photometric_bundle_adjustment_tpu_torch import device as devices
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    device = devices.resolve(device)
    cameras0 = {f: np.array(T, np.float64) for f, T in pipe.cameras.items()}
    landmarks0 = copy.deepcopy(pipe.landmarks)
    rows = []
    for sigma in rungs:
        pipe.cameras = perturb_cameras(cameras0, sigma)
        pipe.landmarks = copy.deepcopy(landmarks0)
        ate0, bl0 = score(pipe), stereo_baseline_stats(pipe.cameras)
        t0 = time.perf_counter()
        res = pba_refine.refine_photometric(
            pipe, max_iterations=max_iterations, huber_delta=huber_delta,
            levels=levels, sample_bf16=bf16, log=lambda s: None,
            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        ate1, bl1 = score(pipe), stereo_baseline_stats(pipe.cameras)
        rows.append({
            "sigma_cm": sigma * 100,
            "ate_init_se3_cm": ate0[0], "ate_init_sim3_cm": ate0[1],
            "ate_pba_se3_cm": ate1[0], "ate_pba_sim3_cm": ate1[1],
            "baseline_init_m": bl0, "baseline_pba_m": bl1,
            "cost": float(res.cost), "initial_cost": float(res.initial_cost),
            "iterations": int(res.iterations),
            "seconds": seconds, "levels": list(pipe.photometric_levels),
        })
    pipe.cameras, pipe.landmarks = cameras0, landmarks0
    return rows


def check_out(path: str) -> None:
    """Refuse to overwrite a record that is not the port's (the JAX TPU
    run's ``runs/value_curve.json``, for one)."""
    if not os.path.exists(path):
        return
    try:
        with open(path) as f:
            backend = json.load(f).get("backend")
    except (OSError, ValueError, AttributeError):
        backend = None
    if backend != "torch":
        raise ValueError(f"{path} holds another run's record, not the "
                         f"port's; choose another --out")


def load_euroc(args, device):
    """The EuRoC route's pipeline, as the JAX script's ``main`` loads it:
    images, calibration, corners (cache or detection), then the map's
    cameras, tracks and landmarks."""
    import pickle

    from photometric_bundle_adjustment_tpu_torch.io import calib_io, dataset
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        Landmark,
        SfmPipeline,
    )

    if not args.dataset_path or not os.path.isdir(args.dataset_path):
        raise FileNotFoundError(
            f"the EuRoC dataset directory {args.dataset_path!r} does not "
            f"exist; pass --dataset-path (or --room for the rendered room)")
    images, _ = dataset.load_images(args.dataset_path, 0)
    calib = calib_io.load_calibration(args.cam_calib)
    with open(args.map, "rb") as f:
        m = pickle.load(f)
    pipe = SfmPipeline(images, calib, cache_dir=args.cache_dir, log=print,
                       device=device)
    if not pipe._load_cache("corners"):
        pipe.detect_keypoints()
    pipe.cameras = {f: np.array(T, np.float64)
                    for f, T in m["cameras"].items()}
    pipe.tracks = dict(m.get("tracks", {}))
    pipe.landmarks = {
        t: Landmark(d["inv_depth"], dict(d["obs"]),
                    dict(d.get("outlier_obs", {})))
        for t, d in m["landmarks"].items()}
    return pipe, calib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--room", action="store_true",
                    help="the rendered indoor room instead of EuRoC V1")
    ap.add_argument("--frames", type=int, default=82,
                    help="stereo frames of the room")
    ap.add_argument("--map", default="runs/map_r5_run12.pkl")
    ap.add_argument("--dataset-path", default=None,
                    help="the EuRoC V1 directory (timestamps.txt, "
                         "<ts>_<cam>.jpg)")
    ap.add_argument("--cam-calib",
                    default="refbaseline/artifacts/ref_opt_calib.json")
    ap.add_argument("--cache-dir", default="runs/cache_r5")
    ap.add_argument("--ref-dump", default=REF_DUMP)
    ap.add_argument("--rungs", default=RUNGS)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from photometric_bundle_adjustment_tpu_torch import device as devices

    device = devices.resolve(args.device)
    check_out(args.out)
    rungs = [float(x) for x in args.rungs.split(",")]
    if args.room:
        from photometric_bundle_adjustment_tpu_torch.models import synthetic
        from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
            SfmPipeline,
        )

        seq = synthetic.synth_stereo_sequence(
            n_frames=args.frames, room_radius=synthetic.INDOOR_ROOM_RADIUS,
            device=device)
        pipe = SfmPipeline(seq.images, seq.calib, log=print, device=device)
        pipe.run()
        calib, score = seq.calib, room_score(seq)
        source = {"scene": "indoor room", "frames": args.frames}
    else:
        pipe, calib = load_euroc(args, device)

        def score(p):
            return score_ate({"cameras": p.cameras}, args.ref_dump)

        source = {"map": args.map, "dataset": args.dataset_path}

    rows = run_ladder(pipe, rungs, score, bf16=args.bf16, device=device)
    for row in rows:
        print(json.dumps(row))
    T = np.asarray(calib.T_i_c)
    out = {"backend": "torch", "device": str(device),
           "card": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else None),
           "bf16": args.bf16, **source,
           "calibrated_baseline_m": float(np.linalg.norm(T[1, :3] - T[0, :3])),
           "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
