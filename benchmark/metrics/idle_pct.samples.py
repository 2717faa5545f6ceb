"""idle_pct.samples: the device's idle share of the traced stretch of
a sampling cell's window, busy the union of the device's activity intervals
(benchmark/trace.py)."""

from benchmark.trace import idle_pct as read  # noqa: F401
