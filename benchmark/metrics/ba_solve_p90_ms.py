"""The 90th percentile of the window's solve latencies, from the call into
the program to its answer on the host (host clock, milliseconds)."""

import statistics


def read(run):
    if len(run.latency) < 10:
        return None
    return 1e3 * statistics.quantiles(run.latency, n=10)[8]
