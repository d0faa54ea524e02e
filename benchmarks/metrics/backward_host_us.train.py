"""Host time of ``train.backward``, the backward (its device work launched from
autograd's thread too), in the profiled steps, a sample (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("train.backward", "host")
