"""Device time of ``train.optimizer``, the optimizer's update, in the profiled
steps, a sample (us)."""
from benchmarks.metrics._spans import span_us

read = span_us("train.optimizer", "device")
