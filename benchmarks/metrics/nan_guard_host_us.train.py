"""Host time of ``train.nan_guard``, the NaN guard (the host's wait for the
device), in the profiled steps, a sample (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("train.nan_guard", "host")
