"""Kernel maps from the dense int32 level grid: CUDA kernel + plain versions,
for the k3 offsets (levels 2-4) and the k5 offsets (level 0).

Source note. Replaces the TPU kernel ``situation3d_tpu/ops/pallas/
map_lookup.py`` (``_lookup_kernel`` / ``k3_map_lookup_pallas``) and, for the
k5 offsets, the reference's XLA ``lookup_kernel_map_dense`` at level 0
(``situation3d_tpu/sparse/kernel_map.py``; ``in_stride == offset_stride ==
1`` there, so it is the same lookup over 125 offsets). Bound on an H100 by
bytes: the map written once, one 4-byte grid probe per entry. The design
(``csrc/map_lookup.cu`` on ``csrc/map_tile.cuh``): a block stages the rows
of 64 voxels, read once; a thread takes one (voxel, dx, dy) column, a z-run
of 3 or 5 consecutive grid ints; the rows leave in 16-byte stores; for k5
the same pass writes the k3 sub-map. Bounds and mask are applied in the
kernel, so the output is the finished map. The TPU kernel's 128-lane
z-packed rows, SMEM index streams and lane-select reduces have no
counterpart here.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from situation3d_tpu_torch.ops.cuda import _build
from situation3d_tpu_torch.sparse.kernel_map import kernel_offsets, lookup_kernel_map_dense

launches = 0      # k3 maps: +1 per kernel launch, nowhere else
k5_launches = 0   # k5 maps (with their k3 sub-map): +1 per launch, nowhere else

# column of each k3 offset in the k5 order (both x slowest)
K3_IN_K5 = [int(np.flatnonzero((kernel_offsets(5) == o).all(1))[0])
            for o in kernel_offsets(3)]


def map_lookup_fits(level_cells: int, z_cells: int,
                    budget_bytes: int = 10 * 2 ** 20) -> bool:
    """The reference's routing rule for its int32-grid kernel (grid under a
    fixed on-chip budget, ``z_cells`` dividing 128), kept so both packages
    send the same level to the same kernel. It is routing parity with the
    reference, not a limit of the card: the CUDA kernel takes any extent."""
    if z_cells <= 0 or 128 % z_cells:
        return False
    blk = 128
    rows = -(-level_cells // 128)
    grid = rows * 128 * 4
    scratch = blk * 128 * 4
    io = 2 * (blk * 4 + blk * 4 + 3 * blk * 4)
    return grid + scratch + io < budget_bytes


def k3_map_lookup_plain(grid_flat: torch.Tensor, out_cells: torch.Tensor,
                        out_mask: torch.Tensor, extent_cells: Sequence[int],
                        v_in: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`k3_map_lookup` (same arguments): the
    dense lookup over ``kernel_offsets(3)`` at stride 1 on the cell grid."""
    return lookup_kernel_map_dense(grid_flat, v_in, out_cells, out_mask,
                                   kernel_offsets(3), 1, 1, tuple(extent_cells))


def k5_map_lookup_plain(grid_flat: torch.Tensor, out_cells: torch.Tensor,
                        out_mask: torch.Tensor, extent_cells: Sequence[int],
                        v_in: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`k5_map_lookup` (same arguments)."""
    map_k5 = lookup_kernel_map_dense(grid_flat, v_in, out_cells, out_mask,
                                     kernel_offsets(5), 1, 1, tuple(extent_cells))
    return map_k5, map_k5[:, :, K3_IN_K5]


def _check(name: str, grid_flat, out_cells, out_mask, extent_cells) -> None:
    X, Y, Z = extent_cells
    B, V = out_mask.shape
    if grid_flat.dtype != torch.int32 or out_cells.dtype != torch.int32 \
            or out_mask.dtype != torch.bool:
        raise TypeError(f"{name} wants int32 grid/cells and a bool mask")
    if grid_flat.shape != (B, X * Y * Z) or out_cells.shape != (B, V, 3):
        raise ValueError(f"shape mismatch: grid {tuple(grid_flat.shape)}, cells "
                         f"{tuple(out_cells.shape)}, mask {tuple(out_mask.shape)}, "
                         f"extent {(X, Y, Z)}")


def _launch(name: str, kernel_size: int, grid_flat, out_cells, out_mask,
            extent_cells, v_in):
    """Launches the kernel on CUDA tensors; returns ``(map [B, V,
    kernel_size^3], k3 sub-map [B, V, 27] or None)``."""
    X, Y, Z = extent_cells
    B, V = out_mask.shape
    if out_cells.device != grid_flat.device or out_mask.device != grid_flat.device:
        raise ValueError(f"{name}: all tensors must be on one device")
    if B * V >= 2 ** 31 or X * Y * Z >= 2 ** 31:
        raise ValueError(f"{name}: B*V and X*Y*Z must stay below 2^31")
    lib = _build.load_library()
    grid_flat, out_cells, out_mask = (t.contiguous() for t in
                                      (grid_flat, out_cells, out_mask))
    out = torch.empty(B, V, kernel_size ** 3, dtype=torch.int32, device=grid_flat.device)
    out_k3 = (torch.empty(B, V, 27, dtype=torch.int32, device=grid_flat.device)
              if kernel_size == 5 else None)
    with torch.cuda.device(grid_flat.device):
        code = lib.s3d_map_lookup(
            grid_flat.data_ptr(), out_cells.data_ptr(), out_mask.data_ptr(),
            out.data_ptr(), None if out_k3 is None else out_k3.data_ptr(),
            B, V, X, Y, Z, kernel_size, int(v_in),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, name)
    return out, out_k3


def k3_map_lookup(grid_flat: torch.Tensor, out_cells: torch.Tensor,
                  out_mask: torch.Tensor, extent_cells: Sequence[int],
                  v_in: int) -> torch.Tensor:
    """k3 kernel map from a dense level grid, batched.

    Args:
      grid_flat: int32 [B, X*Y*Z] dense grid in ``(x*Y + y)*Z + z`` order
        (``sparse.kernel_map.build_level_grid``); empty cells hold ``v_in``.
      out_cells: int32 [B, V, 3] output voxel CELL coords (raw // stride).
      out_mask:  bool [B, V].
      extent_cells: per-level cell extent (X, Y, Z).
      v_in: miss sentinel (== input-level capacity).

    Returns int32 [B, V, 27] in ``kernel_offsets(3)`` order; out-of-extent
    neighbours and masked voxels give ``v_in``. CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise).
    """
    global launches
    extent_cells = tuple(int(e) for e in extent_cells)
    _check("k3_map_lookup", grid_flat, out_cells, out_mask, extent_cells)
    if not grid_flat.is_cuda:
        return k3_map_lookup_plain(grid_flat, out_cells, out_mask, extent_cells, v_in)
    out, _ = _launch("k3_map_lookup", 3, grid_flat, out_cells, out_mask, extent_cells, v_in)
    launches += 1
    return out


def k5_map_lookup(grid_flat: torch.Tensor, out_cells: torch.Tensor,
                  out_mask: torch.Tensor, extent_cells: Sequence[int],
                  v_in: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k5 kernel map and its k3 sub-map from a dense level grid, batched, in
    one pass (level 0: ``out_cells`` are the stride-1 coords).

    Arguments as :func:`k3_map_lookup`. Returns ``(int32 [B, V, 125] in
    ``kernel_offsets(5)`` order, int32 [B, V, 27] == its columns
    ``K3_IN_K5``)``. A voxel outside the extent keeps the neighbours that lie
    inside it. CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise).
    """
    global k5_launches
    extent_cells = tuple(int(e) for e in extent_cells)
    _check("k5_map_lookup", grid_flat, out_cells, out_mask, extent_cells)
    if not grid_flat.is_cuda:
        return k5_map_lookup_plain(grid_flat, out_cells, out_mask, extent_cells, v_in)
    maps = _launch("k5_map_lookup", 5, grid_flat, out_cells, out_mask, extent_cells, v_in)
    k5_launches += 1
    return maps
