"""Host time of ``sig3d.pool``, the situated token pooling, in the profiled
batches, a question (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("sig3d.pool", "host")
