"""The JAX package's SfM run on the port's indoor scene, on the CPU.

    python scripts/sfm_run_jax.py [--frames 82]

Renders ``synth_stereo_sequence(room_radius=INDOOR_ROOM_RADIUS)`` of the
PyTorch port (480x752, seed 0, on the CPU) and runs the JAX package's
``SfmPipeline.run`` on it in f64 with the default ``SfmConfig``, as
``chip_smoke.py`` phase 9 runs the port's.  Prints the pipeline's
log, then one JSON line of the port's ``scripts.sfm_run.measure`` (images
registered, map size, the cam-0 ATE against the rendered poses after an
SE3 alignment, the reprojection RMS) with the stage times and counters:
the CPU reference for ``chip_smoke.py`` phase 9's ATE bound.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=82)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
        SfmPipeline,
    )
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.scripts import sfm_run

    seq = synthetic.synth_stereo_sequence(
        n_frames=args.frames, room_radius=synthetic.INDOOR_ROOM_RADIUS,
        device="cpu")
    pipe = SfmPipeline(seq.images, seq.calib, SfmConfig(),
                       log=lambda s: print(s, flush=True))
    t0 = time.perf_counter()
    pipe.run()
    wall = time.perf_counter() - t0
    out = sfm_run.measure(pipe, seq)
    out.update(frames=args.frames, device="cpu (JAX)", wall_s=wall,
               timings_s=dict(pipe.timings),
               counters=dict(sorted(pipe.counters.items())),
               summary=pipe.summary())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
