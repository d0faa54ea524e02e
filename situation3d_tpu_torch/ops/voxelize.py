"""Fixed-capacity voxel dedup on the device (port of
``situation3d_tpu/ops/voxelize.py``: ``pack_coords``, ``unpack_coords``,
``voxelize_jax``), written with an explicit batch dimension.
"""
from __future__ import annotations

from typing import Tuple

import torch

# per-axis coordinate bound for int32 key packing: 3 * 10 bits = 30 bits < 31.
COORD_BITS = 10
COORD_BOUND = 1 << COORD_BITS
_SENTINEL = 2 ** 31 - 1


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    """Pack non-negative int coords [..., 3] (< COORD_BOUND each) into int32 keys."""
    c = coords.to(torch.int32)
    return (c[..., 0] << (2 * COORD_BITS)) | (c[..., 1] << COORD_BITS) | c[..., 2]


def unpack_coords(keys: torch.Tensor) -> torch.Tensor:
    m = COORD_BOUND - 1
    return torch.stack([(keys >> (2 * COORD_BITS)) & m,
                        (keys >> COORD_BITS) & m, keys & m], dim=-1)


def voxelize_torch(
    coords: torch.Tensor,
    valid: torch.Tensor,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched dedup of integer voxel coords with a fixed capacity: stable
    sort of packed keys, head flags, cumsum ranks.

    Args:
      coords: int32 [B, N, 3] non-negative voxel coords (padding rows arbitrary).
      valid:  bool  [B, N].
      capacity: output voxel budget V.

    Returns (unique_coords int32 [B, V, 3] with zero padding rows,
    unique_mask bool [B, V], inverse int32 [B, N], num_unique int32 [B]).

    On overflow (more uniques than ``capacity``) the surplus merges into the
    last slot and the LARGEST key is kept there — what the reference's
    in-order scatter leaves behind — written here as a single write so the
    result does not depend on the scatter's collision order.
    """
    B, n = valid.shape
    dev = coords.device
    keys = pack_coords(coords.clamp(0, COORD_BOUND - 1))
    keys = torch.where(valid, keys, torch.full_like(keys, _SENTINEL))
    sorted_keys, sorted_idx = torch.sort(keys, dim=1, stable=True)
    head = torch.ones_like(valid)
    head[:, 1:] = sorted_keys[:, 1:] != sorted_keys[:, :-1]
    head &= sorted_keys != _SENTINEL
    uid_sorted = torch.cumsum(head, dim=1, dtype=torch.int32) - 1
    num_unique = head.sum(dim=1, dtype=torch.int32)
    uid = uid_sorted.clamp(0, capacity - 1)
    writes = head & ((uid_sorted < capacity - 1)
                     | (uid_sorted == num_unique[:, None] - 1))
    base = torch.arange(B, device=dev, dtype=torch.int64)[:, None] * capacity
    slot = torch.where(writes, base + uid, torch.full_like(base, B * capacity))
    # one spare slot at the end takes the writes the reference drops
    unique_keys = torch.zeros(B * capacity + 1, dtype=torch.int32, device=dev)
    unique_keys[slot.reshape(-1)] = sorted_keys.reshape(-1)
    unique_keys = unique_keys[:B * capacity].view(B, capacity)
    unique_mask = (torch.arange(capacity, device=dev, dtype=torch.int32)[None]
                   < num_unique[:, None])
    unique_coords = unpack_coords(unique_keys) * unique_mask[..., None]
    inverse = torch.zeros(B, n, dtype=torch.int32, device=dev)
    inverse.scatter_(1, sorted_idx, uid)
    inverse = inverse * valid
    return unique_coords.to(torch.int32), unique_mask, inverse, num_unique
