"""Readings of the expert layer (``ops/cuda/moe_experts.py``): its kernels
by name in the profiled batches' ``device_ops``, and ``ctx["moe_least_of"]``
(tag -> the layer's least seconds in that batch, ``flops/moe.py``). A
program without the layer has none of these kernels, and both read None."""
from __future__ import annotations

from typing import Optional

# the grouped products, the plan that groups the assignments, the ordered sums
MOE_KERNELS = ("moe_grouped_kernel", "segment_plan_kernel", "scatter_add_rows_kernel",
               "scatter_add_narrow_kernel")


def moe_device_s(ctx) -> float:
    return ctx["summary"].kernel_s(*MOE_KERNELS)


def roofline_pct(ctx) -> Optional[float]:
    s, device_s = ctx["summary"], moe_device_s(ctx)
    if ctx.get("moe_least_of") is None or device_s <= 0 or not s.profiled_tags:
        return None
    return 100.0 * sum(ctx["moe_least_of"](t) for t in s.profiled_tags) / device_s


def device_us_per_unit(ctx) -> Optional[float]:
    s, device_s = ctx["summary"], moe_device_s(ctx)
    if s.units <= 0 or device_s <= 0 or "moe_grouped_kernel" not in " ".join(s.device_ops):
        return None
    return 1e6 * device_s / s.units
