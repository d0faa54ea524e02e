"""MinkUNet18A encoder on the sparse engine (port of
``situation3d_tpu/sparse/minkunet.py``: ``build_unet_plan`` dense path,
``BasicBlock``, ``ResLayer`` and ``MinkUNet`` up to ``feat_bottleneck``).

  conv0 (k5, s1) -> [conv k2/s2 -> 2x BasicBlock(k3)] x4 down to stride 16
  (``feat_bottleneck``).

The network stops at the bottleneck: nothing on the QA path reads the
decoder, and eager PyTorch would pay for it. The decoder tail and the
``final`` head come with a later slice.

Gradients: conv0 and every k3 conv are same-coords odd-cube convs and take
the gather-only backward on their own map (``symmetric_bwd``); the k2 down
convs take it on the level's ``map_up`` (``transpose_map``). This is the
reference's ``sparse.gather_bwd=true`` routing and the only backward the port
has, so that field joins the routing fields it reads and ignores.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from situation3d_tpu_torch.config import SparseConfig
from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.ops.cuda.map_bits import (build_level_bits,
                                                     k3_map_lookup_bits,
                                                     map_bits_fits)
from situation3d_tpu_torch.ops.cuda.map_lookup import (k3_map_lookup,
                                                       map_lookup_fits)
from situation3d_tpu_torch.sparse.conv import (SparseBatchNorm, SparseConv,
                                               SparseConv1x1, sparse_relu)
from situation3d_tpu_torch.sparse.kernel_map import (build_level_grid,
                                                     downsample_with_down_map,
                                                     kernel_offsets,
                                                     lookup_kernel_map_dense)
from situation3d_tpu_torch.sparse.tensor import SparseVoxels

STRIDES = (1, 2, 4, 8, 16)


def build_unet_plan(
    coords: torch.Tensor,
    mask: torch.Tensor,
    capacities: Sequence[int],
    extent: Sequence[int] = (512, 512, 256),
    pallas_map: Any = True,
    pallas_map_bits: Any = True,
    device="cuda",
) -> Dict[str, Any]:
    """Build all coordinate sets and kernel maps for the UNet, batched, on
    ``device`` (dense-grid lookups + sort-free downsample; the sort-based
    fallback is not ported yet).

    Args:
      coords: int32 [B, V0, 3] stride-1 voxel coords (padded).
      mask:   bool [B, V0].
      capacities: per-stride voxel budgets for strides (1, 2, 4, 8, 16).
      pallas_map / pallas_map_bits: the reference's switches for its two
        k3-map kernels; any true value enables the route here.

    Routing of the k3 maps mirrors the reference so both frameworks send the
    same level to the same kernel: the int32-grid kernel where
    ``map_lookup_fits`` holds, else the bit-table kernel where the level is
    dense-downsampled (``i >= 1``) and ``map_bits_fits`` holds, else the
    plain dense lookup. At the default extent: level 1 -> bits, levels 2-4
    -> grid. This is routing parity with the reference, not a limit of the
    card. Level 0 builds the k5 map with plain torch ops and slices the k3
    map out of it. The tensors' device decides kernel vs plain version.

    Returns a dict:
      levels: list over strides of {coords, mask, map_k3}; level 0 also has
        map_k5; levels 1.. have map_down; levels ..3 have map_up.
      overflow: {"voxels_dropped": [B], "extent_misses": [B]} int32 counters.
    """
    if len(capacities) != len(STRIDES):
        raise ValueError(f"capacities needs {len(STRIDES)} entries, got {len(capacities)}")
    dev = resolve_device(device)
    coords = torch.as_tensor(coords, device=dev).to(torch.int32)
    mask = torch.as_tensor(mask, device=dev).to(torch.bool)
    extent = tuple(int(e) for e in extent)
    B = coords.shape[0]
    overflow = {"voxels_dropped": torch.zeros(B, dtype=torch.int32, device=dev),
                "extent_misses": torch.zeros(B, dtype=torch.int32, device=dev)}

    levels = [{"coords": coords, "mask": mask}]
    for i in range(1, len(STRIDES)):
        prev = levels[i - 1]
        c, m, dropped, dmap, umap = downsample_with_down_map(
            prev["coords"], prev["mask"], STRIDES[i - 1], 2, capacities[i], extent)
        levels.append({"coords": c, "mask": m, "map_down": dmap})
        prev["map_up"] = umap
        overflow["voxels_dropped"] += dropped

    k5_np = kernel_offsets(5)
    k3_in_k5 = torch.as_tensor(
        [int(np.flatnonzero((k5_np == o).all(1))[0]) for o in kernel_offsets(3)],
        device=dev)

    for i, lvl in enumerate(levels):
        s = STRIDES[i]
        v_in = lvl["coords"].shape[1]
        cells = tuple(e // s for e in extent)
        n_cells = cells[0] * cells[1] * cells[2]
        use_grid = i >= 1 and bool(pallas_map) and map_lookup_fits(n_cells, cells[2])
        use_bits = (i >= 1 and not use_grid and bool(pallas_map_bits)
                    and map_bits_fits(n_cells, cells[2]))
        # a level served by the bit tables needs no grid; it is a
        # dense-downsampled level, whose voxels all lie inside the extent, so
        # it adds nothing to extent_misses
        if not use_bits:
            grid, misses = build_level_grid(lvl["coords"], lvl["mask"], s, extent)
            overflow["extent_misses"] += misses
        if i == 0:
            lvl["map_k5"] = lookup_kernel_map_dense(
                grid, v_in, lvl["coords"], lvl["mask"], k5_np, s, s, extent)
            lvl["map_k3"] = lvl["map_k5"][:, :, k3_in_k5]
        elif use_grid:
            lvl["map_k3"] = k3_map_lookup(grid, lvl["coords"] // s, lvl["mask"],
                                          cells, v_in)
        elif use_bits:
            bits, pfx = build_level_bits(lvl["coords"], lvl["mask"], s, extent)
            lvl["map_k3"] = k3_map_lookup_bits(bits, pfx, lvl["coords"] // s,
                                               lvl["mask"], cells, v_in)
        else:
            lvl["map_k3"] = lookup_kernel_map_dense(
                grid, v_in, lvl["coords"], lvl["mask"], kernel_offsets(3), s, s,
                extent)
        grid = None   # free the level's grid before the next one is built
    return {"levels": levels, "overflow": overflow}


class BasicBlock(nn.Module):
    """ResNet BasicBlock (expansion=1): conv3-bn-relu-conv3-bn + skip."""

    def __init__(self, in_channels: int, planes: int, kernel_volume: int = 27,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = SparseConv(in_channels, planes, kernel_volume, dtype,
                                symmetric_bwd=True)
        self.norm1 = SparseBatchNorm(planes, dtype=dtype)
        self.conv2 = SparseConv(planes, planes, kernel_volume, dtype,
                                symmetric_bwd=True)
        self.norm2 = SparseBatchNorm(planes, dtype=dtype)
        if in_channels != planes:
            self.downsample_conv = SparseConv1x1(in_channels, planes, dtype)
            self.downsample_norm = SparseBatchNorm(planes, dtype=dtype)
        else:
            self.downsample_conv = None

    def forward(self, x: SparseVoxels, nbr_idx) -> SparseVoxels:
        residual = x
        out = self.conv1(x, nbr_idx, x.coords, x.mask, x.stride)
        out = sparse_relu(self.norm1(out))
        out = self.conv2(out, nbr_idx, out.coords, out.mask, out.stride)
        out = self.norm2(out)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(residual))
        return sparse_relu(out.replace(feats=out.feats + residual.feats))


class ResLayer(nn.Module):
    def __init__(self, in_channels: int, planes: int, num_blocks: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"block{i}", BasicBlock(
                in_channels if i == 0 else planes, planes, dtype=dtype))
        self.num_blocks = num_blocks

    def forward(self, x: SparseVoxels, nbr_idx) -> SparseVoxels:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, nbr_idx)
        return x


class MinkUNet(nn.Module):
    """MinkUNet18A encoder half; its batch norms are always in evaluation
    form. Submodule names follow the
    reference's parameter tree (``conv0p1s1``, ``bn0``, ``conv1p1s2``, ...,
    ``block4``)."""

    def __init__(self, cfg: SparseConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.final_result:
            raise NotImplementedError(
                "sparse.final_result (decoder tail + 768-d head) is not ported "
                "yet: it comes with the decoder/segmentation slice")
        if not (cfg.dense_lookup and cfg.dense_downsample):
            raise NotImplementedError(
                "the sort-based plan construction (sparse.dense_lookup=false or "
                "sparse.dense_downsample=false) is not ported yet")
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.init_dim
        self.conv0p1s1 = SparseConv(cfg.in_channels, d, 125, dtype,
                                    symmetric_bwd=True)
        self.bn0 = SparseBatchNorm(d, dtype=dtype)
        ch = d
        for i in range(1, 5):
            self.add_module(f"conv{i}p{STRIDES[i - 1]}s2", SparseConv(ch, ch, 8, dtype))
            self.add_module(f"bn{i}", SparseBatchNorm(ch, dtype=dtype))
            self.add_module(f"block{i}", ResLayer(ch, cfg.planes[i - 1],
                                                  cfg.layers[i - 1], dtype))
            ch = cfg.planes[i - 1]

    def forward(self, x: SparseVoxels, plan: Dict[str, Any]) -> Dict[str, Any]:
        L = plan["levels"]
        x = x.replace(feats=x.feats.to(self.dtype))
        h = self.conv0p1s1(x, L[0]["map_k5"], L[0]["coords"], L[0]["mask"], 1)
        h = sparse_relu(self.bn0(h))
        for i in range(1, 5):
            conv = getattr(self, f"conv{i}p{STRIDES[i - 1]}s2")
            h = conv(h, L[i]["map_down"], L[i]["coords"], L[i]["mask"], STRIDES[i],
                     transpose_map=L[i - 1]["map_up"])
            h = sparse_relu(getattr(self, f"bn{i}")(h))
            h = getattr(self, f"block{i}")(h, L[i]["map_k3"])
        return {"feat_bottleneck": h}   # stride 16
