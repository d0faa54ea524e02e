"""Voxelization (port of ``situation3d_tpu/ops/voxelize.py``).

* :func:`sparse_quantize_np` / :func:`voxelize_np`: the numpy host path of
  the data pipeline (first-occurrence dedup of integer voxel coords), a copy
  of the reference's;
* :func:`voxelize_torch`: fixed-capacity dedup on the device (``pack_coords``,
  ``unpack_coords``, ``voxelize_jax``), written with an explicit batch
  dimension.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# per-axis coordinate bound for int32 key packing: 3 * 10 bits = 30 bits < 31.
COORD_BITS = 10
COORD_BOUND = 1 << COORD_BITS
_SENTINEL = 2 ** 31 - 1


def sparse_quantize_np(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dedup integer voxel coords.

    Returns ``(first_index, inverse)``: ``first_index`` indexes the first
    occurrence (in original order) of each unique coord, in the order of the
    coords' lexicographic keys, and ``inverse`` maps every input row to its
    unique id (the reference's ``sparse_quantize(..., return_index=True,
    return_inverse=True)``).
    """
    coords = np.ascontiguousarray(coords.astype(np.int64))
    mins = coords.min(axis=0)
    shifted = coords - mins
    spans = shifted.max(axis=0) + 1
    key = (shifted[:, 0] * spans[1] + shifted[:, 1]) * spans[2] + shifted[:, 2]
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    head = np.ones(len(key), dtype=bool)
    head[1:] = sorted_key[1:] != sorted_key[:-1]
    unique_id_sorted = np.cumsum(head) - 1
    inverse = np.empty(len(key), dtype=np.int64)
    inverse[order] = unique_id_sorted
    first_index = order[head]
    return first_index, inverse


def voxelize_np(points: np.ndarray, voxel_size: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize float points to voxel coords (scale by 1 / voxel_size, floor,
    translate to zero minimum) and dedup, first occurrence kept.

    Returns ``(voxel_coords int32 [M, 3], first_index [M], inverse [N])``.
    """
    coords = np.floor(points / voxel_size).astype(np.int64)
    coords -= coords.min(axis=0)
    first_index, inverse = sparse_quantize_np(coords)
    return coords[first_index].astype(np.int32), first_index, inverse


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
