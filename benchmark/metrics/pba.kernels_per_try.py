"""Device operations per LM try in the traced requests:
``trace.kernels_per_try``."""

from benchmark.trace import kernels_per_try as read  # noqa: F401
