"""k3 kernel map from bit-packed occupancy + prefix popcounts: CUDA kernel,
the function that makes its tables, and plain version.

Source note. Replaces the TPU kernel ``situation3d_tpu/ops/pallas/
map_bits.py`` (``_bits_kernel`` / ``k3_map_lookup_bits``; helper
``build_level_bits``). Bound on an H100 by bytes: two 4-byte table reads and
one 4-byte store per map entry; the popcount is one instruction. The design
(``csrc/map_bits.cu``) is one thread per (sample, voxel, offset), words read
as ``uint32_t`` and ranked with ``__popc``; bounds and mask are applied in
the kernel. The tables are 1/16 of the int32 grid's bytes, so a level whose
grid is tens of MB is probed from L2-sized tables. The TPU kernel's packed
128-lane rows, Lo/Hi word selects and sign-safe shift tricks have no
counterpart here.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from situation3d_tpu_torch.ops.cuda import _build
from situation3d_tpu_torch.sparse.kernel_map import _cumsum_rows, kernel_offsets

launches = 0   # +1 per kernel launch, nowhere else

_U32 = 0xFFFFFFFF


def map_bits_fits(level_cells: int, z_cells: int,
                  budget_bytes: int = 10 * 2 ** 20) -> bool:
    """The reference's routing rule for its bit-table kernel (``z_cells`` a
    multiple of 32 whose word count divides 128, tables under a fixed on-chip
    budget), kept so both packages send the same level to the same kernel.
    Routing parity with the reference, not a limit of the card."""
    if z_cells <= 0 or z_cells % 32:
        return False
    zw = z_cells // 32
    if 128 % zw:
        return False
    blk = 128
    words = -(-level_cells // 32)
    rows = -(-words // 128)
    tables = 2 * rows * 128 * 4
    scratch = 2 * blk * 128 * 4
    io = 2 * (blk * 4 * 3 + blk * 4 + 3 * blk * 4)
    return tables + scratch + io < budget_bytes


def _popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """Popcount of int64 values holding unsigned 32-bit words."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _U32) >> 24


def build_level_bits(coords: torch.Tensor, mask: torch.Tensor, stride: int,
                     extent: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occupancy bits + exclusive prefix popcount for one level, batched.

    Valid ONLY for levels whose voxel table is unique and ascending in
    flat-cell order (levels produced by the dense downsample). Bit math runs
    in int64 on unsigned 32-bit values and the words are stored as the int32
    with the same bit pattern, so the tables equal the reference's including
    bit 31.

    Args: coords int32 [B, V, 3] raw units; mask bool [B, V].
    Returns (bits int32 [B, Wp], pfx int32 [B, Wp]), Wp padded to 128 words.
    """
    B = mask.shape[0]
    dev = coords.device
    dx, dy, dz = (e // stride for e in extent)
    total = dx * dy * dz
    words = -(-total // 32)
    wp = words + ((-words) % 128)
    c = torch.div(coords, stride, rounding_mode="floor").to(torch.int64)
    in_ext = (mask & (c >= 0).all(dim=-1)
              & (c[..., 0] < dx) & (c[..., 1] < dy) & (c[..., 2] < dz))
    flat = (c[..., 0] * dy + c[..., 1]) * dz + c[..., 2]
    base = torch.arange(B, device=dev, dtype=torch.int64)[:, None] * wp
    w = torch.where(in_ext, base + (flat >> 5), B * wp)
    add = torch.where(in_ext, torch.ones_like(flat) << (flat & 31), 0)
    # cells are unique -> distinct powers of two per word: add == or
    bits = torch.zeros(B * wp + 1, dtype=torch.int64, device=dev)
    bits.index_add_(0, w.reshape(-1), add.reshape(-1))
    bits = bits[:B * wp].view(B, wp) & _U32
    pc = _popcount_u32(bits)
    pc = pc.to(torch.int32)
    pfx = _cumsum_rows(pc) - pc                               # exclusive
    bits_i32 = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits_i32.to(torch.int32), pfx


def k3_map_lookup_bits_plain(bits: torch.Tensor, pfx: torch.Tensor,
                             out_cells: torch.Tensor, out_mask: torch.Tensor,
                             extent_cells: Sequence[int], v_in: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`k3_map_lookup_bits` (same arguments)."""
    X, Y, Z = extent_cells
    wp = bits.shape[1]
    offs = torch.as_tensor(kernel_offsets(3), device=out_cells.device)
    q = out_cells[:, :, None, :] + offs                       # [B, V, 27, 3]
    ok = ((q[..., 0] >= 0) & (q[..., 0] < X) & (q[..., 1] >= 0)
          & (q[..., 1] < Y) & (q[..., 2] >= 0) & (q[..., 2] < Z)
          & out_mask[..., None])
    q = q.to(torch.int64)
    flat = ((q[..., 0] * Y + q[..., 1]) * Z + q[..., 2]).clamp_(0, X * Y * Z - 1)
    w = (flat >> 5).clamp_(max=wp - 1).flatten(1)
    bit = flat & 31
    word = torch.gather(bits, 1, w).view(flat.shape).to(torch.int64) & _U32
    base = torch.gather(pfx, 1, w).view(flat.shape).to(torch.int64)
    occ = ((word >> bit) & 1) == 1
    rank = base + _popcount_u32(word & ((torch.ones_like(bit) << bit) - 1))
    return torch.where(ok & occ, rank, v_in).to(torch.int32)


def k3_map_lookup_bits(bits: torch.Tensor, pfx: torch.Tensor,
                       out_cells: torch.Tensor, out_mask: torch.Tensor,
                       extent_cells: Sequence[int], v_in: int) -> torch.Tensor:
    """k3 kernel map from bit-packed occupancy, batched.

    Args:
      bits: int32 [B, Wp] occupancy words from :func:`build_level_bits`.
      pfx:  int32 [B, Wp] exclusive prefix popcounts.
      out_cells: int32 [B, V, 3] output voxel CELL coords (raw // stride).
      out_mask:  bool [B, V].
      extent_cells: per-level cell extent (X, Y, Z).
      v_in: miss sentinel (== input-level capacity).

    Returns int32 [B, V, 27] in ``kernel_offsets(3)`` order; equal to the
    dense-grid map when the level's voxels are the occupied cells in
    ascending flat order. CPU tensors run the plain version; CUDA tensors
    launch the kernel (or raise).
    """
    X, Y, Z = (int(e) for e in extent_cells)
    B, V = out_mask.shape
    if bits.dtype != torch.int32 or pfx.dtype != torch.int32 \
            or out_cells.dtype != torch.int32 or out_mask.dtype != torch.bool:
        raise TypeError("k3_map_lookup_bits wants int32 tables/cells and a bool mask")
    wp = bits.shape[1]
    if bits.shape != pfx.shape or bits.shape[0] != B \
            or out_cells.shape != (B, V, 3) or wp * 32 < X * Y * Z:
        raise ValueError(f"shape mismatch: bits {tuple(bits.shape)}, pfx "
                         f"{tuple(pfx.shape)}, cells {tuple(out_cells.shape)}, "
                         f"mask {tuple(out_mask.shape)}, extent {(X, Y, Z)}")
    if not bits.is_cuda:
        return k3_map_lookup_bits_plain(bits, pfx, out_cells, out_mask,
                                        (X, Y, Z), v_in)
    if any(t.device != bits.device for t in (pfx, out_cells, out_mask)):
        raise ValueError("k3_map_lookup_bits: all tensors must be on one device")
    global launches
    lib = _build.load_library()
    bits, pfx, out_cells, out_mask = (t.contiguous() for t in
                                      (bits, pfx, out_cells, out_mask))
    out = torch.empty(B, V, 27, dtype=torch.int32, device=bits.device)
    with torch.cuda.device(bits.device):
        code = lib.s3d_k3_map_lookup_bits(
            bits.data_ptr(), pfx.data_ptr(), out_cells.data_ptr(),
            out_mask.data_ptr(), out.data_ptr(), B, V, wp, X, Y, Z, int(v_in),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "k3_map_lookup_bits")
    launches += 1
    return out
