"""Device time of ``blip2.qformer``, the Q-Former with its position encoding and
projection, in the profiled batches, a question (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("blip2.qformer", "device")
