"""Device time of ``t5.encoder``, the T5 encoder, in the profiled batches, a
question (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("t5.encoder", "device")
