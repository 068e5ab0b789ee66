"""Named time ranges of the program, on the profiler's clock when one runs.

``span(name)`` times its block on the host (``time.perf_counter``; the
object the ``with`` statement binds holds ``.seconds`` once the block has
left).  While a ``torch.profiler`` session is active in the process, the
span is also recorded as a profiler range of that name: it then lies on
the clock of the device operations launched inside it, whose runtime
calls a trace can match to the innermost span open at the launch.
Without a session a span costs the profiler's is-enabled check and two
clock reads; it never syncs the device and allocates nothing there.

The range is a function-scope ``RecordFunction``
(``torch._C._profiler._RecordFunctionFast``), not a
``torch.profiler.record_function``: a user-scope range also gets a copy
on the device timeline, typed as a device event, which a reduction that
takes every device event for an operation (``benchmark/trace.py``) would
count as a kernel and as busy time.  A function-scope range stays on the
host timeline, beside the operators.

There are no counters besides the spans themselves: the number of spans
of a name is its count (``lm.accept`` once a try).  The names the port
records (``pba.*`` in ``pipeline/pba_refine``, ``geo.*`` in
``models/geometric_ba``, ``lm.*`` in ``optim/ba``'s two LM loops) start
with ``PREFIXES``.
"""

from __future__ import annotations

import time

import torch

PREFIXES = ("pba.", "geo.", "lm.")


class span:
    """``with span(name) as s: ...``; ``s.seconds`` is the block's host
    duration, set on exit."""

    __slots__ = ("name", "seconds", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.seconds = None

    def __enter__(self):
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def is_annotation(event) -> bool:
    """Whether a ``torch.profiler`` event (or ``key_averages`` entry) is a
    range rather than an operation: a user annotation (a
    ``record_function``, on the host or its copy on the device timeline)
    or one of the port's spans."""
    return bool(getattr(event, "is_user_annotation", False)
                or event.key.startswith(PREFIXES))
