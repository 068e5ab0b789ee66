"""The JAX package's photometric refinement and ``--global-init`` run on
the port's indoor scene, on the CPU.

    python scripts/pba_global_jax.py [--frames 82] [--out result.json]

Renders ``synth_stereo_sequence(room_radius=INDOOR_ROOM_RADIUS)`` of the
PyTorch port (480x752, seed 0, on the CPU) and runs on it, with the JAX
package in f64 and the default ``SfmConfig``:

1. ``SfmPipeline.run`` from images to a finished map (as
   ``scripts/sfm_run_jax.py`` does), then ``refine_photometric`` of that
   map with ``apps/pba``'s defaults (3 levels, 20 iterations, Huber 9,
   f32): the reference of ``chip_smoke.py`` phase 10;
2. ``apps/sfm --global-init``'s flow on the same corners and matches
   (steps until the tracks exist, ``global_initialize``,
   ``Stage.OPTIMIZE``, ``run``): the reference of phase 11.

Each map is scored by the port's ``scripts.sfm_run.measure`` (images
registered, map size, the cam-0 ATE against the rendered poses after an
SE3 alignment, the reprojection RMS).  Prints the pipeline's log, then
one JSON line of the three results and their seconds.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=82)
    ap.add_argument("--out", default="",
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from photometric_bundle_adjustment_tpu.pipeline import (
        global_init,
        pba_refine,
    )
    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
        SfmPipeline,
        Stage,
    )
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.scripts import sfm_run

    def log(s):
        print(s, flush=True)

    seq = synthetic.synth_stereo_sequence(
        n_frames=args.frames, room_radius=synthetic.INDOOR_ROOM_RADIUS,
        device="cpu")
    out = {"frames": args.frames, "device": "cpu (JAX)"}

    pipe = SfmPipeline(seq.images, seq.calib, SfmConfig(), log=log)
    t0 = time.perf_counter()
    while not (pipe.corners and pipe.matches):
        pipe.next_step()
    corners = copy.deepcopy(pipe.corners)
    matches = copy.deepcopy(pipe.matches)
    t_front = time.perf_counter() - t0
    pipe.run()
    out["sfm"] = sfm_run.measure(pipe, seq)
    out["sfm"].update(wall_s=time.perf_counter() - t0, front_s=t_front,
                      summary=pipe.summary())
    log(json.dumps({"sfm": out["sfm"]}))

    t0 = time.perf_counter()
    lines = []
    res = pba_refine.refine_photometric(
        pipe, log=lambda s: (lines.append(s), log(s)))
    out["pba"] = sfm_run.measure(pipe, seq)
    out["pba"].update(wall_s=time.perf_counter() - t0,
                      initial_cost=float(res.initial_cost),
                      cost=float(res.cost), levels=lines[:-1])
    log(json.dumps({"pba": out["pba"]}))

    gpipe = SfmPipeline(seq.images, seq.calib, SfmConfig(), log=log)
    gpipe.corners, gpipe.matches = corners, matches
    t0 = time.perf_counter()
    while not gpipe.tracks and gpipe.next_step():
        pass
    t1 = time.perf_counter()
    global_init.global_initialize(gpipe)
    t_init = time.perf_counter() - t1
    gpipe.stage = Stage.OPTIMIZE
    gpipe.run()
    out["global_init"] = sfm_run.measure(gpipe, seq)
    out["global_init"].update(wall_s=time.perf_counter() - t0,
                              global_initialize_s=t_init,
                              summary=gpipe.summary())
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
