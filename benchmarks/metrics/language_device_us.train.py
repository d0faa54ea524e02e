"""Device time of ``sig3d.language``, the language encoder (MPNet), in the
profiled steps, a sample (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("sig3d.language", "device")
