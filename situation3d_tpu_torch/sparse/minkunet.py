"""MinkUNet18A on the sparse engine (port of
``situation3d_tpu/sparse/minkunet.py``: ``build_unet_plan`` dense path,
``BasicBlock``, ``ResLayer`` and ``MinkUNet``).

  conv0 (k5, s1) -> [conv k2/s2 -> 2x BasicBlock(k3)] x4 down to stride 16
  (``feat_bottleneck``) -> [transposed conv k2 on map_up -> cat(skip) ->
  2x BasicBlock(k3)] x2 (``feat_layer5``, ``feat_layer6``) and, under
  ``sparse.final_result``, x2 more and the 1x1 ``final`` head
  (``openscene_out``).

``MinkUNet.forward(..., bottleneck_only=True)`` stops at the bottleneck:
nothing on the QA path reads the decoder, and eager PyTorch would pay for
it (the reference builds it and XLA drops it as dead code). Its parameters
exist either way, as in the reference's tree.

Gradients: conv0 and every k3 conv are same-coords odd-cube convs and take
the gather-only backward on their own map (``symmetric_bwd``); the k2 down
convs take it on the finer level's ``map_up``, the transposed convs on the
coarser level's ``map_down`` (``transpose_map``: a down map and an up map
share their column order, so no kernel flip). This is the reference's
``sparse.gather_bwd=true`` routing and the only backward the port has, so
that field joins the routing fields it reads and ignores.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from situation3d_tpu_torch.config import SparseConfig
from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.ops.cuda.map_bits import (build_level_bits,
                                                     k3_map_lookup_bits,
                                                     map_bits_fits)
from situation3d_tpu_torch.ops.cuda.map_lookup import (k3_map_lookup,
                                                       k5_map_lookup,
                                                       map_lookup_fits)
from situation3d_tpu_torch.sparse.conv import (SparseBatchNorm, SparseConv,
                                               SparseConv1x1, sparse_relu)
from situation3d_tpu_torch.sparse.kernel_map import (build_kernel_map,
                                                     build_level_grid,
                                                     downsample_coords,
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
    dense_lookup: bool = True,
    dense_downsample: bool = True,
) -> Dict[str, Any]:
    """Build all coordinate sets and kernel maps for the UNet, batched, on
    ``device``.

    Args:
      coords: int32 [B, V0, 3] stride-1 voxel coords (padded).
      mask:   bool [B, V0].
      capacities: per-stride voxel budgets for strides (1, 2, 4, 8, 16).
      pallas_map / pallas_map_bits: the reference's switches for its two
        k3-map kernels; any true value enables the route here.
      dense_lookup: maps from dense level grids over ``extent`` (voxels
        outside it get no neighbours and are counted in ``extent_misses``);
        false: the sort-based maps, which take any coords below
        ``COORD_BOUND`` per axis (scenes beyond the extent).
      dense_downsample: with ``dense_lookup``, the sort-free downsample that
        writes the k2 down and up maps in the same pass; otherwise the
        downsample sorts and the k2 maps are looked up like the k3 maps.

    Routing of the maps mirrors the reference so both frameworks send the
    same level to the same kernel. With ``dense_lookup``: level 0's k5 map
    (the reference's XLA dense lookup, which slices its k3 map out of it) goes
    through the int32-grid kernel with the 125 k5 offsets, whose one pass also
    writes the k3 map; a level's k3 map goes to the int32-grid kernel where
    ``map_lookup_fits`` holds, else to the bit-table kernel where the level
    was dense-downsampled (``i >= 1``) and ``map_bits_fits`` holds, else to
    the plain dense lookup. At the default extent: level 1 -> bits (grid
    lookup without ``dense_downsample``), levels 2-4 -> grid. Without
    ``dense_lookup`` no map kernel runs. The tensors' device decides kernel
    vs plain version.

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
    k2, k3 = kernel_offsets(2), kernel_offsets(3)

    levels = [{"coords": coords, "mask": mask}]
    for i in range(1, len(STRIDES)):
        prev = levels[i - 1]
        if dense_lookup and dense_downsample:
            c, m, dropped, dmap, umap = downsample_with_down_map(
                prev["coords"], prev["mask"], STRIDES[i - 1], 2, capacities[i], extent)
            levels.append({"coords": c, "mask": m, "map_down": dmap})
            prev["map_up"] = umap
        else:
            c, m, dropped = downsample_coords(prev["coords"], prev["mask"],
                                              STRIDES[i - 1], 2, capacities[i])
            levels.append({"coords": c, "mask": m})
        overflow["voxels_dropped"] += dropped

    if not dense_lookup:
        k3_in_k5 = [int(np.flatnonzero((kernel_offsets(5) == o).all(1))[0]) for o in k3]
        for i, lvl in enumerate(levels):
            s = STRIDES[i]
            if i == 0:
                lvl["map_k5"] = build_kernel_map(coords, mask, coords, mask,
                                                 kernel_offsets(5), 1, 1)
                lvl["map_k3"] = lvl["map_k5"][:, :, k3_in_k5].contiguous()
            else:
                lvl["map_k3"] = build_kernel_map(lvl["coords"], lvl["mask"], lvl["coords"],
                                                 lvl["mask"], k3, s, s)
                fine = levels[i - 1]
                lvl["map_down"] = build_kernel_map(fine["coords"], fine["mask"], lvl["coords"],
                                                   lvl["mask"], k2, STRIDES[i - 1],
                                                   STRIDES[i - 1])
                fine["map_up"] = build_kernel_map(lvl["coords"], lvl["mask"], fine["coords"],
                                                  fine["mask"], -k2, s, STRIDES[i - 1])
        return {"levels": levels, "overflow": overflow}

    prev_grid = None
    for i, lvl in enumerate(levels):
        s = STRIDES[i]
        v_in = lvl["coords"].shape[1]
        cells = tuple(e // s for e in extent)
        n_cells = cells[0] * cells[1] * cells[2]
        use_grid = i >= 1 and bool(pallas_map) and map_lookup_fits(n_cells, cells[2])
        use_bits = (i >= 1 and dense_downsample and not use_grid and bool(pallas_map_bits)
                    and map_bits_fits(n_cells, cells[2]))
        # a level served by the bit tables needs no grid; it is a
        # dense-downsampled level, whose voxels all lie inside the extent, so
        # it adds nothing to extent_misses
        grid = None
        if not use_bits:
            grid, misses = build_level_grid(lvl["coords"], lvl["mask"], s, extent)
            overflow["extent_misses"] += misses
        if i == 0:      # stride 1: the coords are the cells
            lvl["map_k5"], lvl["map_k3"] = k5_map_lookup(grid, lvl["coords"],
                                                         lvl["mask"], cells, v_in)
        elif use_grid:
            lvl["map_k3"] = k3_map_lookup(grid, lvl["coords"] // s, lvl["mask"],
                                          cells, v_in)
        elif use_bits:
            bits, pfx = build_level_bits(lvl["coords"], lvl["mask"], s, extent)
            lvl["map_k3"] = k3_map_lookup_bits(bits, pfx, lvl["coords"] // s,
                                               lvl["mask"], cells, v_in)
        else:
            lvl["map_k3"] = lookup_kernel_map_dense(grid, v_in, lvl["coords"], lvl["mask"],
                                                    k3, s, s, extent)
        if i > 0 and "map_down" not in lvl:
            # the sorted downsample: the k2 maps from the two levels' grids
            fine, sf = levels[i - 1], STRIDES[i - 1]
            lvl["map_down"] = lookup_kernel_map_dense(
                prev_grid, fine["coords"].shape[1], lvl["coords"], lvl["mask"], k2, sf, sf,
                extent)
            fine["map_up"] = lookup_kernel_map_dense(
                grid, v_in, fine["coords"], fine["mask"], -k2, s, sf, extent)
        # keep this level's grid for the next level's k2 maps only when the
        # downsample did not write them
        prev_grid = None if dense_downsample else grid
        grid = None
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

    def forward(self, x: SparseVoxels, nbr_idx, train: bool = False,
                momentum: Optional[float] = None) -> SparseVoxels:
        bn = dict(use_running_average=not train, momentum=momentum)
        residual = x
        out = self.conv1(x, nbr_idx, x.coords, x.mask, x.stride)
        out = sparse_relu(self.norm1(out, **bn))
        out = self.conv2(out, nbr_idx, out.coords, out.mask, out.stride)
        out = self.norm2(out, **bn)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(residual), **bn)
        return sparse_relu(out.replace(feats=out.feats + residual.feats))


class ResLayer(nn.Module):
    def __init__(self, in_channels: int, planes: int, num_blocks: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"block{i}", BasicBlock(
                in_channels if i == 0 else planes, planes, dtype=dtype))
        self.num_blocks = num_blocks

    def forward(self, x: SparseVoxels, nbr_idx, train: bool = False,
                momentum: Optional[float] = None) -> SparseVoxels:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, nbr_idx, train, momentum)
        return x


# the decoder's stages: (transposed conv, its norm, layer, index into
# ``cfg.planes``, input level, skip it concatenates); the last two run under
# ``final_result`` only
DECODER = (("convtr4p16s2", "bntr4", "block5", 4, 4, "out_b3p8"),
           ("convtr5p8s2", "bntr5", "block6", 5, 3, "out_b2p4"),
           ("convtr6p4s2", "bntr6", "block7", 6, 2, "out_b1p2"),
           ("convtr7p2s2", "bntr7", "block8", 7, 1, "out_p1"))


class MinkUNet(nn.Module):
    """MinkUNet18A. Submodule names follow the reference's parameter tree
    (``conv0p1s1``, ``bn0``, ``conv1p1s2``, ..., ``block4``,
    ``convtr4p16s2``, ``bntr4``, ..., ``block8``, ``final``). Its batch norms
    take the running statistics unless ``forward(..., train=True)``, which
    normalizes with the batch's and moves the running statistics by
    ``momentum`` (the reference's convention; ``train/optim.py:
    bn_momentum_schedule`` gives it an epoch's value)."""

    def __init__(self, cfg: SparseConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
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
        skip_ch = {"out_b3p8": cfg.planes[2], "out_b2p4": cfg.planes[1],
                   "out_b1p2": cfg.planes[0], "out_p1": d}
        for conv, bn, layer, p, _, skip in self._decoder():
            self.add_module(conv, SparseConv(ch, cfg.planes[p], 8, dtype))
            self.add_module(bn, SparseBatchNorm(cfg.planes[p], dtype=dtype))
            self.add_module(layer, ResLayer(cfg.planes[p] + skip_ch[skip],
                                            cfg.planes[p], cfg.layers[p], dtype))
            ch = cfg.planes[p]
        if cfg.final_result:
            self.final = SparseConv1x1(ch, cfg.out_channels, dtype, use_bias=True)

    def _decoder(self):
        return DECODER if self.cfg.final_result else DECODER[:2]

    def forward(self, x: SparseVoxels, plan: Dict[str, Any], train: bool = False,
                momentum: Optional[float] = None,
                bottleneck_only: bool = False) -> Dict[str, Any]:
        """Returns ``feat_bottleneck`` (stride 16), ``feat_layer5`` (8),
        ``feat_layer6`` (4) and, under ``final_result``, ``openscene_out``
        (stride 1, ``out_channels``); only the first if
        ``bottleneck_only``. ``train`` puts every batch norm in training
        form."""
        L = plan["levels"]
        bn = dict(use_running_average=not train, momentum=momentum)
        x = x.replace(feats=x.feats.to(self.dtype))
        h = self.conv0p1s1(x, L[0]["map_k5"], L[0]["coords"], L[0]["mask"], 1)
        h = sparse_relu(self.bn0(h, **bn))
        skips = {"out_p1": h}
        for i in range(1, 5):
            conv = getattr(self, f"conv{i}p{STRIDES[i - 1]}s2")
            h = conv(h, L[i]["map_down"], L[i]["coords"], L[i]["mask"], STRIDES[i],
                     transpose_map=L[i - 1]["map_up"])
            h = sparse_relu(getattr(self, f"bn{i}")(h, **bn))
            h = getattr(self, f"block{i}")(h, L[i]["map_k3"], train, momentum)
            skips[f"out_b{i}p{STRIDES[i]}"] = h
        out = {"feat_bottleneck": h}
        if bottleneck_only:
            return out
        for conv, norm, layer, _, i, skip in self._decoder():
            # the transposed conv: level i's map_up gathers from level i, its
            # backward runs on level i's map_down
            h = getattr(self, conv)(h, L[i - 1]["map_up"], L[i - 1]["coords"],
                                    L[i - 1]["mask"], STRIDES[i - 1],
                                    transpose_map=L[i]["map_down"])
            h = sparse_relu(getattr(self, norm)(h, **bn)).cat(skips[skip])
            h = getattr(self, layer)(h, L[i - 1]["map_k3"], train, momentum)
            if layer in ("block5", "block6"):
                out[f"feat_layer{layer[-1]}"] = h
        if self.cfg.final_result:
            out["openscene_out"] = self.final(h)
        return out
