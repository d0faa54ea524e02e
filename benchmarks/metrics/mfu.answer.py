"""The whole step's model FLOPs over its wall time, against the bf16 peak (%)."""
from benchmarks.metrics._common import mfu_pct as read  # noqa: F401
