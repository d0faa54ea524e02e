"""``fused_sparse_conv``'s least time on this cell's maps over its kernels'
device time in the profiled batches (%)."""
from benchmarks.metrics._common import conv_roofline_pct as read  # noqa: F401
