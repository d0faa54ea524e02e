"""Sparse-convolution coordinate management (port of
``situation3d_tpu/sparse/kernel_map.py``): the dense level grids, and the
sort-based path for scenes beyond the grid extent (packed int32 keys sorted
once a level, neighbour queries as binary searches, a strided downsample as a
fixed-capacity dedup).

All functions take an explicit batch dimension. Integer outputs are int32
like the reference's and match it bit for bit.

The reference scatters with ``mode="drop"`` (out-of-range writes vanish);
``index_put_`` has no such mode, so every scatter target here is one flat
buffer over the whole batch with ONE spare slot at the end that takes the
dropped writes and is sliced off.
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from situation3d_tpu_torch.ops.voxelize import (_SENTINEL, COORD_BOUND,
                                                pack_coords, voxelize_torch)


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """Integer kernel offsets [K, 3] in the canonical order (x slowest).

    Odd kernel => centered hypercube; even kernel => [0, k).
    """
    if kernel_size % 2 == 1:
        r = kernel_size // 2
        rng = range(-r, r + 1)
    else:
        rng = range(kernel_size)
    return np.array(list(itertools.product(rng, rng, rng)), dtype=np.int32)


def _cells(coords: torch.Tensor, stride: int) -> torch.Tensor:
    return torch.div(coords, stride, rounding_mode="floor")


def _in_extent(c: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    dx, dy, dz = dims
    return ((c[..., 0] >= 0) & (c[..., 0] < dx) & (c[..., 1] >= 0)
            & (c[..., 1] < dy) & (c[..., 2] >= 0) & (c[..., 2] < dz))


def _flat(c: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """int64 flat cell id ``(x*Y + y)*Z + z``."""
    c = c.to(torch.int64)
    return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]


def _batch_base(B: int, per_sample: int, device) -> torch.Tensor:
    return torch.arange(B, device=device, dtype=torch.int64)[:, None] * per_sample


def _cumsum_rows(x: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Inclusive int32 ``cumsum`` along dim 1 of ``[B, n]``, as two short
    scans (within chunks, then over chunk totals): a few rows of millions of
    cells give ``torch.cumsum`` one block per row to work with, many short
    rows fill the card. Integer sums, so the result is the same."""
    B, n = x.shape
    if n <= chunk:
        return torch.cumsum(x, dim=1, dtype=torch.int32)
    pad = (-n) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    y = torch.cumsum(x.view(B, -1, chunk), dim=2, dtype=torch.int32)
    totals = y[:, :, -1]
    y += (torch.cumsum(totals, dim=1, dtype=torch.int32) - totals)[:, :, None]
    return y.view(B, -1)[:, :n]


def _sorted_key_table(coords: torch.Tensor, mask: torch.Tensor, stride: int):
    """Sorted packed keys ``[B, V]`` and their original rows (stable: equal
    keys keep their row order); masked rows take the sentinel key."""
    keys = pack_coords(_cells(coords, stride))
    keys = torch.where(mask, keys, torch.full_like(keys, _SENTINEL))
    return torch.sort(keys, dim=1, stable=True)


def _lookup(sorted_keys, sorted_idx, query_keys, query_valid, miss: int):
    """Row of each query key (the first of equal keys: the lowest original
    row), ``miss`` where the key is absent or the query is not valid."""
    B, V = sorted_keys.shape
    pos = torch.searchsorted(sorted_keys, query_keys.reshape(B, -1), right=False,
                             out_int32=True).clamp_(max=V - 1).to(torch.int64)
    hit = (torch.gather(sorted_keys, 1, pos) == query_keys.reshape(B, -1)) \
        & query_valid.reshape(B, -1)
    found = torch.gather(sorted_idx, 1, pos).to(torch.int32)
    return torch.where(hit, found, miss).view(query_keys.shape)


def build_kernel_map(
    in_coords: torch.Tensor,
    in_mask: torch.Tensor,
    out_coords: torch.Tensor,
    out_mask: torch.Tensor,
    offsets: np.ndarray,
    in_stride: int,
    offset_stride: int,
) -> torch.Tensor:
    """Neighbour map of a sparse conv by binary search: for output voxel j and
    offset k the input row at ``out_coords[j] + offsets[k] * offset_stride``,
    or ``V_in``. A query counts when it is divisible by ``in_stride``, lies in
    ``[0, COORD_BOUND * in_stride)`` on every axis and its output row is
    valid.

    Args: in_coords int32 [B, V_in, 3] (multiples of ``in_stride``); in_mask
    bool [B, V_in]; out_coords int32 [B, V_out, 3]; out_mask bool [B, V_out];
    offsets int [K, 3]. Returns int32 [B, V_out, K].
    """
    v_in = in_coords.shape[1]
    sorted_keys, sorted_idx = _sorted_key_table(in_coords, in_mask, in_stride)
    offs = torch.as_tensor(np.asarray(offsets), dtype=torch.int32,
                           device=out_coords.device) * offset_stride
    q = out_coords[:, :, None, :] + offs                      # [B, V_out, K, 3]
    bound = COORD_BOUND * in_stride
    valid = ((torch.remainder(q, in_stride) == 0) & (q >= 0) & (q < bound)).all(dim=-1) \
        & out_mask[..., None]
    qkeys = pack_coords(_cells(q.clamp(0, bound - 1), in_stride))
    return _lookup(sorted_keys, sorted_idx, qkeys, valid, v_in)


def downsample_coords(
    coords: torch.Tensor,
    mask: torch.Tensor,
    stride: int,
    factor: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Output coords of a strided conv by sort and dedup:
    ``unique(floor(c / new_stride)) * new_stride`` in ascending key order,
    ``new_stride = stride * factor``.

    Returns ``(out_coords int32 [B, capacity, 3], out_mask bool [B, capacity],
    dropped int32 [B])``; ``dropped`` counts the unique cells beyond
    ``capacity``, which merge into the last slot (the largest key wins).
    """
    new_stride = stride * factor
    uc, um, _, nu = voxelize_torch(_cells(coords, new_stride), mask, capacity)
    return uc * new_stride, um, (nu - capacity).clamp(min=0)


def gather_neighbors(feats: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Neighbour features with a zero row for misses.

    Args: feats [B, V_in, C]; nbr_idx int32 [B, V_out, K] (miss == V_in).
    Returns [B, V_out, K, C].
    """
    B, _, C = feats.shape
    padded = torch.cat([feats, feats.new_zeros(B, 1, C)], dim=1)
    flat = nbr_idx.reshape(B, -1, 1).to(torch.int64).expand(-1, -1, C)
    return torch.gather(padded, 1, flat).view(*nbr_idx.shape, C)


def build_level_grid(
    in_coords: torch.Tensor,
    in_mask: torch.Tensor,
    in_stride: int,
    extent: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense index grid for one level: ``grid[b, flat(c // stride)]`` = voxel
    row id, miss sentinel ``V_in`` elsewhere.

    Args: in_coords int32 [B, V, 3] raw units; in_mask bool [B, V].
    Returns ``(grid int32 [B, X*Y*Z], extent_misses int32 [B])``: voxels
    outside the extent are left out of the grid and counted.
    """
    B, v_in = in_mask.shape
    dev = in_coords.device
    dims = tuple(e // in_stride for e in extent)
    total = dims[0] * dims[1] * dims[2]
    c = _cells(in_coords, in_stride)
    in_ext = _in_extent(c, dims)
    ok = in_mask & in_ext
    write = torch.where(ok, _batch_base(B, total, dev) + _flat(c, dims),
                        B * total)
    grid = torch.full((B * total + 1,), v_in, dtype=torch.int32, device=dev)
    idx = torch.arange(v_in, device=dev, dtype=torch.int32).expand(B, v_in)
    grid[write.reshape(-1)] = idx.reshape(-1)
    extent_misses = (in_mask & ~in_ext).sum(dim=1, dtype=torch.int32)
    return grid[:B * total].view(B, total), extent_misses


def lookup_kernel_map_dense(
    grid: torch.Tensor,
    v_in: int,
    out_coords: torch.Tensor,
    out_mask: torch.Tensor,
    offsets: np.ndarray,
    in_stride: int,
    offset_stride: int,
    extent: Sequence[int],
) -> torch.Tensor:
    """Kernel map via dense-grid gathers: for output voxel j and offset k the
    input row at ``out_coords[j] + offsets[k] * offset_stride``, or ``v_in``.

    Args: grid int32 [B, X*Y*Z]; out_coords int32 [B, V_out, 3]; out_mask
    bool [B, V_out]; offsets int [K, 3]. Returns int32 [B, V_out, K].

    For more than 27 offsets (the level-0 k5 map) the queries are formed one
    sample at a time: the batched ``[B, V, 125, 3]`` query tensor and its
    int64 flat ids would be several GB of temporaries.
    """
    B = out_mask.shape[0]
    dev = out_coords.device
    dims = tuple(e // in_stride for e in extent)
    offs = torch.as_tensor(np.asarray(offsets), dtype=torch.int32,
                           device=dev) * offset_stride

    def one(g, oc, om):
        q = oc[..., None, :] + offs                       # [..., V, K, 3]
        divisible = (torch.remainder(q, in_stride) == 0).all(dim=-1)
        qc = _cells(q, in_stride)
        valid = divisible & _in_extent(qc, dims) & om[..., None]
        qflat = _flat(qc, dims).clamp_(0, g.shape[-1] - 1)
        hit = torch.gather(g, -1, qflat.flatten(-2)).view(qflat.shape)
        return torch.where(valid, hit, torch.full_like(hit, v_in))

    if offs.shape[0] <= 27:
        return one(grid, out_coords, out_mask)
    return torch.stack([one(grid[b], out_coords[b], out_mask[b])
                        for b in range(B)])


def downsample_with_down_map(
    coords: torch.Tensor,
    mask: torch.Tensor,
    stride: int,
    factor: int,
    capacity: int,
    extent: Sequence[int],
):
    """Sort-free strided downsample (grid occupancy + cumsum compaction) with
    the kernel-2 down and up maps as byproducts.

    Output coords are the unique ``floor(c / new_stride) * new_stride`` in
    ascending flat-grid order. Every fine voxel determines its own map
    entries: its coarse cell's output ``slot`` and its parity per axis give
    ``down_map[slot, (ox*2+oy)*2+oz] = v`` and ``up_map[v, same column] =
    slot``. On capacity overflow the surplus cells merge into the last slot,
    where only the largest cell writes, so collisions stay deterministic.

    Args: coords int32 [B, V_in, 3]; mask bool [B, V_in].
    Returns ``(out_coords int32 [B, cap, 3], out_mask bool [B, cap],
    dropped int32 [B], down_map int32 [B, cap, f^3] (miss = V_in),
    up_map int32 [B, V_in, f^3] (miss = cap))``.
    """
    B, v_in = mask.shape
    dev = coords.device
    new_stride = stride * factor
    dims = tuple(e // new_stride for e in extent)
    total = dims[0] * dims[1] * dims[2]
    nk = factor ** 3
    c = _cells(coords, new_stride)
    in_ext = mask & _in_extent(c, dims)
    flat = _flat(c, dims)
    cell_base = _batch_base(B, total, dev)
    occ = torch.zeros(B * total + 1, dtype=torch.int32, device=dev)
    # colliding writes all store 1
    occ[torch.where(in_ext, cell_base + flat, B * total).reshape(-1)] = 1
    pos = _cumsum_rows(occ[:B * total].view(B, total))
    n_unique = pos[:, -1:]                                    # [B, 1]
    rank = torch.gather(pos, 1, torch.where(in_ext, flat, 0))  # 1-based
    slot = rank - 1
    keep = ((slot < capacity - 1)
            | ((n_unique <= capacity) & (slot < capacity))
            | (rank == n_unique))
    ok = in_ext & keep
    slot_c = slot.clamp(max=capacity - 1).to(torch.int64)

    # fine voxels of one cell write the same coords: benign collisions
    out = torch.zeros(B * capacity + 1, 3, dtype=torch.int32, device=dev)
    slot_base = _batch_base(B, capacity, dev)
    write = torch.where(ok, slot_base + slot_c, B * capacity)
    out[write.reshape(-1)] = (c * new_stride).to(torch.int32).reshape(-1, 3)
    out = out[:B * capacity].view(B, capacity, 3)
    out_mask = (torch.arange(capacity, device=dev, dtype=torch.int32)[None]
                < n_unique.clamp(max=capacity))
    dropped = ((n_unique[:, 0] - capacity).clamp(min=0)
               + (mask & ~in_ext).sum(dim=1, dtype=torch.int32))

    # parity of the fine coord inside its coarse cell -> kernel_offsets column
    p = _cells(coords, stride) & (factor - 1)
    o = ((p[..., 0] * factor + p[..., 1]) * factor + p[..., 2]).to(torch.int64)
    idx = torch.arange(v_in, device=dev, dtype=torch.int32).expand(B, v_in)
    down_map = torch.full(((B * capacity + 1) * nk,), v_in,
                          dtype=torch.int32, device=dev)
    down_map[(write * nk + o).reshape(-1)] = idx.reshape(-1)
    down_map = down_map[:B * capacity * nk].view(B, capacity, nk)

    up_map = torch.full(((B * v_in + 1) * nk,), capacity,
                        dtype=torch.int32, device=dev)
    row = torch.where(ok, _batch_base(B, v_in, dev) + idx, B * v_in)
    up_map[(row * nk + o).reshape(-1)] = torch.where(
        ok, slot_c, capacity).to(torch.int32).reshape(-1)
    up_map = up_map[:B * v_in * nk].view(B, v_in, nk)
    return out, out_mask, dropped.to(torch.int32), down_map, up_map
