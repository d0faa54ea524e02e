"""Host time of ``t5.decode_step``, the greedy decode steps, all of a batch, in
the profiled batches, a question (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("t5.decode_step", "host")
