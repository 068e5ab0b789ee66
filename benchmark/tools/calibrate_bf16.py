"""Readings that the limits of the bf16 cell's checks are set from.

    python3 -m benchmark.tools.calibrate_bf16 --seeds 11,12,... \\
        [--workload pba-room164-bf16] [--requests 2]

As ``calibrate`` does, for each seed and requests 1..``--requests``: the
program's answer judged against the bf16 float64 reference as a run
judges it (``program``), the reference's own answer (``reference``) and
the control's (``control``: the reference with TF32 matrix products); and
besides, the program's float32 tier's answer to the same request
(``f32_tier``), which a limit has to tell apart, and the request's start
(``start``: the program with no iteration, the fault of a solve that
returns its state unchanged).  One JSON line per request on standard
output.  Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import run as bench, scenes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="pba-room164-bf16")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_bf16: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = bench.resolve(args.workload)
    driver = cell.driver().Driver(cell.config, device)
    still = cell.driver().Driver(dict(cell.config, iterations=0), device)
    answers = dict(program=driver.call, control=driver.control,
                   f32_tier=driver.f32_tier, start=still.call)
    for seed in (int(s) for s in args.seeds.split(",")):
        scene = scenes.make_scene(cell.traffic, seed, device=device)
        for i in range(1, args.requests + 1):
            line = dict(cell=cell.name, seed=seed, request=i)
            t = time.perf_counter()
            ref = driver.reference(scene.request(i))
            line["reference_s"] = time.perf_counter() - t
            own = driver.answer(ref)
            line["reference"] = driver.compare(own, own["cost"], ref)
            for name, answer in answers.items():
                t = time.perf_counter()
                out = answer(scene.request(i))
                line[f"{name}_s"] = time.perf_counter() - t
                line[name] = driver.compare(out, out["cost"], ref)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
