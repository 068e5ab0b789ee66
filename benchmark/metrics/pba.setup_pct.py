"""Share of a refinement spent outside the levels' LM solves: the
problem built from the map, the pyramid, each level's problem and solver
plans (request wall less the program's per-level ``solve_s``), %."""


def read(run):
    wall = sum(run.latency)
    solve = sum(lv["solve_s"] for o in run.outputs for lv in o["levels"])
    return 100.0 * (wall - solve) / wall if wall > 0 else None
