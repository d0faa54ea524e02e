"""Host time of ``sig3d.encoder``, the sparse encoder, in the profiled batches, a
question (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("sig3d.encoder", "host")
