"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: device kernels by name, the device's busy time as the union of its
kernels' intervals, and the idle gaps between them labelled by the
harness's span that was open on the host at the time.

The harness marks its spans with ``torch.profiler.record_function`` (the
request's preparation and the call into the program), so they share the
trace's clock with the kernels."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

SPANS = ("request.prepare", "refine_map", "bundle_adjustment")


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


@dataclass
class Trace:
    """A traced stretch of the window: ``kernels`` as (name, start_us,
    end_us), ``spans`` as (name, start_us, end_us), ``wall_s`` its length
    on the host clock."""

    kernels: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.kernels]) / 1e6

    def kernel_seconds(self, match: str) -> float:
        return sum(e - s for n, s, e in self.kernels if match in n) / 1e6

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return sorted(([n, t] for n, t in by.items()), key=lambda x: -x[1])[
            :top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device work, each labelled by the
        innermost harness span open at its midpoint (``host`` where none
        is)."""
        busy = merged([(s, e) for _, s, e in self.kernels])
        spans = [x for x in self.spans]
        if not spans:
            return []
        t0 = min(s for _, s, _ in spans)
        t1 = max(e for _, _, e in spans)
        gaps, cur = [], t0
        for s, e in busy + [[t1, t1]]:
            if s > cur:
                gaps.append((cur, min(s, t1)))
            cur = max(cur, e)
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            open_ = [(ss, n) for n, ss, ee in spans if ss <= mid <= ee]
            label = max(open_)[1] if open_ else "host"
            out.append([label, (e - s) / 1e6])
        return sorted(out, key=lambda x: -x[1])[:top]


def from_profiler(prof, wall_s: float) -> Trace:
    kernels, spans = [], []
    for e in prof.events():
        if e.name in SPANS and e.device_type != torch.autograd.DeviceType.CPU:
            continue        # the span's annotation on the device timeline
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name in SPANS:
            spans.append((e.name, e.time_range.start, e.time_range.end))
    return Trace(kernels=kernels, spans=spans, wall_s=wall_s)


def idle_pct(run):
    """Share of the traced requests' wall time in which no operation ran on
    the device (100 less the union of the device operations' intervals over
    the traced stretch), %; ``run`` a ``run.Run``."""
    if run.trace is None or run.trace.wall_s <= 0 or not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)


def kernels_per_try(run):
    """Device operations (kernels, copies, fills) per LM try in the traced
    requests (each output's ``tries``: every pyramid level's, for a
    refinement)."""
    if run.trace is None or not run.trace.kernels:
        return None
    tries = sum(o["tries"] for o in run.outputs[:run.traced])
    return len(run.trace.kernels) / tries if tries else None
