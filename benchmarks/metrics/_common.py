"""Readings shared by the per-layer metrics. ``ctx`` holds the traced run's
``summary`` (``harness/trace.py:TraceSummary``), ``flops_of(tag)`` (model
FLOPs of one batch of the loop), ``conv_least_of(tag)`` (the fused convs'
least seconds in that batch, None where the cell runs no encoder) and the
spans the cell's loop records itself (``encode_ms``)."""
from __future__ import annotations

import statistics
from typing import Optional

from benchmarks.flops.peaks import BF16_FLOPS

CONV_KERNELS = ("conv_wgmma_kernel", "conv_stream_kernel")


def idle_pct(ctx) -> Optional[float]:
    s = ctx["summary"]
    if s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def launches_per_unit(ctx) -> Optional[float]:
    s = ctx["summary"]
    if s.units <= 0 or s.launches <= 0:
        return None
    return s.launches / s.units


def mfu_pct(ctx) -> Optional[float]:
    """Model FLOPs of the batches the profiler left alone over their own
    wall seconds, against the bf16 peak."""
    s = ctx["summary"]
    if s.quiet_s <= 0 or not s.quiet_tags:
        return None
    return 100.0 * sum(ctx["flops_of"](t) for t in s.quiet_tags) / (s.quiet_s * BF16_FLOPS)


def conv_roofline_pct(ctx) -> Optional[float]:
    s = ctx["summary"]
    device_s = s.kernel_s(*CONV_KERNELS)
    if ctx.get("conv_least_of") is None or device_s <= 0:
        return None
    return 100.0 * sum(ctx["conv_least_of"](t) for t in s.profiled_tags) / device_s


def median_ms(values) -> Optional[float]:
    return statistics.median(values) if values else None
