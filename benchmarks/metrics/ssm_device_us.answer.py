"""The Mamba-2 recurrence kernels' device time in the profiled batches, in µs
a question."""
from benchmarks.metrics._ssm import device_us_per_unit as read  # noqa: F401
