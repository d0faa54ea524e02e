"""T5-style log-bucketed relative position bias indices (port of
``situation3d_tpu/models/relpos.py``), used by the MPNet encoder."""
from __future__ import annotations

import math

import torch


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool = True, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Relative position -> bucket id (int64, ready for an embedding lookup)."""
    rp = relative_position
    ret = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rp > 0).to(rp.dtype) * num_buckets
        n = rp.abs()
    else:
        n = (-rp).clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(rp.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def relative_position_matrix(q_len: int, k_len: int, device=None) -> torch.Tensor:
    """[q_len, k_len] memory_position - query_position."""
    ctx = torch.arange(q_len, device=device)[:, None]
    mem = torch.arange(k_len, device=device)[None, :]
    return mem - ctx
