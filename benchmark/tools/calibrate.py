"""Readings that the limits of a cell's checks are set from.

    python3 -m benchmark.tools.calibrate --workload <cell> \\
        --seeds 11,12,... [--requests 2] [--control 1] [--f32ref 0]

For each seed: the cell's scene, then requests 1..``--requests`` through
the program, each judged against the float64 reference as a run judges
it (the reference's own answer too, as ``reference``); with
``--control 1`` the control too (the driver's ``control``: the precision
below the configuration's), with ``--f32ref 1`` the reference
in float32 without TF32 (a float32 solve that is not the program).
One JSON line per request on standard output.  Needs the card, as a run
does.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--f32ref", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = bench.resolve(args.workload)
    driver = cell.driver().Driver(cell.config, device)
    for seed in (int(s) for s in args.seeds.split(",")):
        scene = scenes.make_scene(cell.traffic, seed, device=device)
        for i in range(1, args.requests + 1):
            line = dict(cell=cell.name, seed=seed, request=i)
            t = time.perf_counter()
            out = driver.call(scene.request(i))
            line["program_s"] = time.perf_counter() - t
            t = time.perf_counter()
            ref = driver.reference(scene.request(i))
            line["reference_s"] = time.perf_counter() - t
            line["program"] = driver.compare(out, out["cost"], ref)
            own = driver.answer(ref)
            line["reference"] = driver.compare(own, own["cost"], ref)
            if args.control:
                t = time.perf_counter()
                c = driver.control(scene.request(i))
                line["control_s"] = time.perf_counter() - t
                line["control"] = driver.compare(c, c["cost"], ref)
            if args.f32ref:
                t = time.perf_counter()
                c = driver.answer(driver.reference(scene.request(i),
                                                   torch.float32))
                line["f32ref_s"] = time.perf_counter() - t
                line["f32ref"] = driver.compare(c, c["cost"], ref)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
