"""Host time of ``sig3d.encoder``, the sparse encoder, in the profiled steps, a
sample (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("sig3d.encoder", "host")
