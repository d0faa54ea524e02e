"""Kernel launches the host issued in the profiled batches, a question."""
from benchmarks.metrics._common import launches_per_unit as read  # noqa: F401
