"""Host time of ``sig3d.input``, the batch's copy to the card, in the profiled
batches, a question (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("sig3d.input", "host")
