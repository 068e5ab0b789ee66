"""Milliseconds of solve latency per LM try: the window's latencies over
its tries (the plan, builds and damped solves together)."""


def read(run):
    tries = sum(o["tries"] for o in run.outputs)
    return 1e3 * sum(run.latency) / tries if tries else None
