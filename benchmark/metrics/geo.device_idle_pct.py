"""Device idle share of the traced requests, %: ``trace.idle_pct``."""

from benchmark.trace import idle_pct as read  # noqa: F401
