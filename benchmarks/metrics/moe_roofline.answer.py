"""The expert layer's least time (``flops/moe.py``: its experts' weights
streamed once, or its products at the bf16 peak, from the routing's counts)
over the device time of its kernels in the profiled batches (%)."""
from benchmarks.metrics._moe import roofline_pct as read  # noqa: F401
