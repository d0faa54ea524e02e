"""The expert layer's kernels' device time in the profiled batches, in µs a
question."""
from benchmarks.metrics._moe import device_us_per_unit as read  # noqa: F401
