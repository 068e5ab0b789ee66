"""The JAX package's photometric value curve on the port's indoor scene,
on the CPU.

    python scripts/pba_value_curve_jax.py [--frames 82]
        [--rungs 0,0.02,0.05,0.10,0.20] [--out result.json]

Renders ``synth_stereo_sequence(room_radius=INDOOR_ROOM_RADIUS)`` of the
PyTorch port (480x752, seed 0, on the CPU), maps it with the JAX
package's ``SfmPipeline.run`` in f64 (default ``SfmConfig``), then runs
the ladder of ``scripts/pba_value_curve.py`` on that map: each rung
perturbs a copy of the finished map's cameras with that script's own
``perturb_cameras`` (numpy seed 0, gauge pair kept) and refines it with
the JAX ``refine_photometric`` (3 levels, 20 iterations, Huber 9, f32).
Both trajectories are scored as the port's
``scripts/pba_value_curve.room_score`` does (the cam-0 ATE against the
rendered poses after an SE3 and a Sim3 alignment, in cm) and by the
stereo baselines' (median, std).  Prints one JSON line per rung with the
root script's keys (plus the per-level log lines and the seconds): the
reference of ``chip_smoke.py`` phase 16.

After each rung, the port's ``run_ladder`` takes it on the CPU from the
same finished map (its cameras, landmarks, tracks and the detections'
``uv``, carried into a port ``SfmPipeline`` through
``interop.set_map_state``), so that a difference between the card's
ladder and this one can be put on the map or on the refinement.  Its
row is printed after the JAX row, with ``"backend": "torch"``; the last
line is the whole result.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=82)
    ap.add_argument("--rungs", default="0,0.02,0.05,0.10,0.20")
    ap.add_argument("--out", default="",
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from photometric_bundle_adjustment_tpu.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
        SfmPipeline,
    )
    from photometric_bundle_adjustment_tpu_torch import interop
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.pipeline import (
        sfm_pipeline as port_sfm,
    )
    from photometric_bundle_adjustment_tpu_torch.scripts import sfm_run
    from photometric_bundle_adjustment_tpu_torch.scripts import (
        pba_value_curve as port_vc,
    )

    spec = importlib.util.spec_from_file_location(
        "pba_value_curve", os.path.join(ROOT, "scripts", "pba_value_curve.py"))
    ladder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ladder)

    seq = synthetic.synth_stereo_sequence(
        n_frames=args.frames, room_radius=synthetic.INDOOR_ROOM_RADIUS,
        device="cpu")
    out = {"frames": args.frames, "device": "cpu (JAX)", "rows": [],
           "port_rows": []}
    pipe = SfmPipeline(seq.images, seq.calib, SfmConfig(),
                       log=lambda s: None)
    t0 = time.perf_counter()
    pipe.run()
    out["sfm"] = sfm_run.measure(pipe, seq)
    out["sfm"].update(wall_s=time.perf_counter() - t0,
                      summary=pipe.summary())
    print(json.dumps({"sfm": out["sfm"]}), flush=True)

    score = port_vc.room_score(seq)
    port = port_sfm.SfmPipeline(seq.images, seq.calib, log=lambda s: None,
                                device="cpu")
    port.corners = {f: {"uv": np.asarray(c["uv"])}
                    for f, c in pipe.corners.items()}
    interop.set_map_state(port, interop.map_state_to_numpy(pipe))
    cameras0 = copy.deepcopy(pipe.cameras)
    landmarks0 = copy.deepcopy(pipe.landmarks)
    for sigma in [float(x) for x in args.rungs.split(",")]:
        pipe.cameras = ladder.perturb_cameras(dict(cameras0), sigma)
        pipe.landmarks = copy.deepcopy(landmarks0)
        ate0 = score(pipe)
        bl0 = ladder.stereo_baseline_stats(pipe.cameras)
        lines = []
        t0 = time.perf_counter()
        res = pba_refine.refine_photometric(
            pipe, max_iterations=20, huber_delta=9.0, log=lines.append)
        seconds = time.perf_counter() - t0
        ate1 = score(pipe)
        bl1 = ladder.stereo_baseline_stats(pipe.cameras)
        row = {
            "sigma_cm": sigma * 100,
            "ate_init_se3_cm": ate0[0], "ate_init_sim3_cm": ate0[1],
            "ate_pba_se3_cm": ate1[0], "ate_pba_sim3_cm": ate1[1],
            "baseline_init_m": bl0, "baseline_pba_m": bl1,
            "cost": float(res.cost), "initial_cost": float(res.initial_cost),
            "iterations": int(res.iterations),
            "seconds": seconds, "levels": lines[:-1],
        }
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
        # the port's rung on the same map, from its unperturbed state
        row, = port_vc.run_ladder(port, [sigma], score, device="cpu")
        out["port_rows"].append(row)
        print(json.dumps({"backend": "torch", **row}), flush=True)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
