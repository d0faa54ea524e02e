"""The Mamba-2 recurrence kernels' least time (``flops/nemotron_h.py``: their
bytes at HBM bandwidth or their operations at the bf16 peak, from the
program's device counters) over their device time in the profiled batches
(%)."""
from benchmarks.metrics._ssm import roofline_pct as read  # noqa: F401
