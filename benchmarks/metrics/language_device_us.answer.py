"""Device time of ``sig3d.language``, the language encoder (MPNet), in the
profiled batches, a question (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("sig3d.language", "device")
