"""Host time of ``sig3d.fusion``, fusion and heads (re-encoding, MCAN, heads), in
the profiled steps, a sample (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("sig3d.fusion", "host")
