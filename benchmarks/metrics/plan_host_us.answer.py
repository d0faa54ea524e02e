"""Host time of ``sig3d.plan``, the UNet plan's build, in the profiled batches, a
question (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("sig3d.plan", "host")
