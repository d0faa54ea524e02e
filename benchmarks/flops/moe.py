"""The expert layer's least time on an H100: the larger of its bytes over
HBM bandwidth and its operations over the bf16 peak, from the routing's own
counts (so from no kernel's work): ``experts_read``, the (call, expert)
pairs with at least one row, each streaming its three bfloat16 matrices
once; ``rows_routed``, the (token, expert) assignments, each two products
through ``w1`` and ``w3`` and one through ``w2``. Each routed token's row
is read once in bfloat16 and its float32 sum written once."""
from __future__ import annotations

from benchmarks.flops.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def moe_bytes(experts_read: float, rows_routed: float, hidden: int, width: int, top_k: int
              ) -> float:
    tokens = rows_routed / top_k
    return experts_read * 3 * hidden * width * 2 + tokens * hidden * (2 + 4)


def moe_flops(rows_routed: float, hidden: int, width: int) -> float:
    return rows_routed * 2 * 3 * hidden * width


def moe_least_s(experts_read: float, rows_routed: float, hidden: int, width: int, top_k: int
                ) -> float:
    return max(moe_bytes(experts_read, rows_routed, hidden, width, top_k) / HBM_BYTES_PER_S,
               moe_flops(rows_routed, hidden, width) / BF16_FLOPS)
