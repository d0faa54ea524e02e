"""The device's idle share of the profiled batches' wall time (%)."""
from benchmarks.metrics._common import idle_pct as read  # noqa: F401
