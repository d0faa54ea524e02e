"""k3 kernel map from the dense int32 level grid: CUDA kernel + plain version.

Source note. Replaces the TPU kernel ``situation3d_tpu/ops/pallas/
map_lookup.py`` (``_lookup_kernel`` / ``k3_map_lookup_pallas``). Bound on an
H100 by bytes: one 4-byte grid probe and one 4-byte store per map entry, no
arithmetic to speak of. The design (``csrc/map_lookup.cu``) is one thread per
(sample, voxel, offset) with the offset fastest, so stores are contiguous and
the three z-neighbours of a column probe consecutive cells; bounds and mask
are applied in the kernel, so the output is the finished map. The TPU
kernel's 128-lane z-packed rows, SMEM index streams and lane-select reduces
have no counterpart here.
"""
from __future__ import annotations

from typing import Sequence

import torch

from situation3d_tpu_torch.ops.cuda import _build
from situation3d_tpu_torch.sparse.kernel_map import kernel_offsets

launches = 0   # +1 per kernel launch, nowhere else


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
    """Plain PyTorch version of :func:`k3_map_lookup` (same arguments)."""
    X, Y, Z = extent_cells
    offs = torch.as_tensor(kernel_offsets(3), device=out_cells.device)
    q = out_cells[:, :, None, :] + offs                       # [B, V, 27, 3]
    ok = ((q[..., 0] >= 0) & (q[..., 0] < X) & (q[..., 1] >= 0)
          & (q[..., 1] < Y) & (q[..., 2] >= 0) & (q[..., 2] < Z)
          & out_mask[..., None])
    q = q.to(torch.int64)
    flat = ((q[..., 0] * Y + q[..., 1]) * Z + q[..., 2]).clamp_(0, X * Y * Z - 1)
    hit = torch.gather(grid_flat, 1, flat.flatten(1)).view(flat.shape)
    return torch.where(ok, hit, torch.full_like(hit, v_in))


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
    X, Y, Z = (int(e) for e in extent_cells)
    B, V = out_mask.shape
    if grid_flat.dtype != torch.int32 or out_cells.dtype != torch.int32 \
            or out_mask.dtype != torch.bool:
        raise TypeError("k3_map_lookup wants int32 grid/cells and a bool mask")
    if grid_flat.shape != (B, X * Y * Z) or out_cells.shape != (B, V, 3):
        raise ValueError(f"shape mismatch: grid {tuple(grid_flat.shape)}, cells "
                         f"{tuple(out_cells.shape)}, mask {tuple(out_mask.shape)}, "
                         f"extent {(X, Y, Z)}")
    if not grid_flat.is_cuda:
        return k3_map_lookup_plain(grid_flat, out_cells, out_mask, (X, Y, Z), v_in)
    if out_cells.device != grid_flat.device or out_mask.device != grid_flat.device:
        raise ValueError("k3_map_lookup: all tensors must be on one device")
    global launches
    lib = _build.load_library()
    grid_flat, out_cells, out_mask = (t.contiguous() for t in
                                      (grid_flat, out_cells, out_mask))
    out = torch.empty(B, V, 27, dtype=torch.int32, device=grid_flat.device)
    with torch.cuda.device(grid_flat.device):
        code = lib.s3d_k3_map_lookup(
            grid_flat.data_ptr(), out_cells.data_ptr(), out_mask.data_ptr(),
            out.data_ptr(), B, V, X, Y, Z, int(v_in),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "k3_map_lookup")
    launches += 1
    return out
