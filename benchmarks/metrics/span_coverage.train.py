"""The busy device time of the profiled steps laid to any of the port's
spans (%)."""
from benchmarks.metrics._spans import coverage_pct as read  # noqa: F401
