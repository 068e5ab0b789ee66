"""``pba.plan_ms`` reads the traced requests' level ``setup_s`` (the
program's ``pba.level.plan`` spans) and nothing without a trace."""

from __future__ import annotations

import pytest

from benchmark import run as bench
from benchmark import trace


def _run(traced: int, with_trace: bool) -> bench.Run:
    outputs = [dict(tries=3, levels=[dict(setup_s=0.010 * (i + 1), tries=1)
                                     for _ in range(3)])
               for i in range(4)]
    return bench.Run(cell="pba-room164-f32", setup_s=1.0, outputs=outputs,
                     latency=[0.5] * 4,
                     trace=trace.Trace() if with_trace else None,
                     traced=traced)


def test_plan_ms_reads_the_traced_requests():
    read = bench.resolve("pba-room164-f32").reader("pba.plan_ms")
    # requests 1 and 2 traced: 3 levels of 10 ms, then of 20 ms
    assert read(_run(2, True)) == pytest.approx(45.0)
    assert read(_run(2, False)) is None
    assert read(_run(0, True)) is None
