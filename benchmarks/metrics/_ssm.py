"""Readings of the Mamba-2 recurrence kernels (``ops/cuda/ssm_scan.py``): by
name in the profiled batches' ``device_ops``, and ``ctx["ssm_least_of"]``
(tag -> the kernels' least seconds in that batch, ``flops/nemotron_h.py``).
A program without them has none of these kernels, and both read None."""
from __future__ import annotations

from typing import Optional

# the prefill's scan and the decode step's update
SSM_KERNELS = ("ssm_scan_kernel", "ssm_update_kernel")


def ssm_device_s(ctx) -> float:
    return ctx["summary"].kernel_s(*SSM_KERNELS)


def roofline_pct(ctx) -> Optional[float]:
    s, device_s = ctx["summary"], ssm_device_s(ctx)
    if ctx.get("ssm_least_of") is None or device_s <= 0 or not s.profiled_tags:
        return None
    return 100.0 * sum(ctx["ssm_least_of"](t) for t in s.profiled_tags) / device_s


def device_us_per_unit(ctx) -> Optional[float]:
    s, device_s = ctx["summary"], ssm_device_s(ctx)
    if s.units <= 0 or device_s <= 0:
        return None
    return 1e6 * device_s / s.units
