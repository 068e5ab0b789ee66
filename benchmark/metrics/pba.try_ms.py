"""Milliseconds per LM try of the megakernel solver: the program's
per-level solve seconds over its tries, summed over the window."""


def read(run):
    solve = sum(lv["solve_s"] for o in run.outputs for lv in o["levels"])
    tries = sum(lv["tries"] for o in run.outputs for lv in o["levels"])
    return 1e3 * solve / tries if tries else None
