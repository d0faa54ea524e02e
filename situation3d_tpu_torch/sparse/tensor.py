"""Batched fixed-capacity sparse voxel tensor (port of
``situation3d_tpu/sparse/tensor.py``).

Voxels live in a dense padded ``[B, V, ...]`` layout with a validity mask;
masked rows hold zeros and gather zeros.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SparseVoxels:
    """A batch of sparse voxel sets at a common tensor stride.

    Attributes:
      coords: int32 [B, V, 3] voxel coords in stride-1 units (multiples of
        ``stride``); padding rows are zero.
      feats:  [B, V, C] features; padding rows are zero.
      mask:   bool [B, V] validity.
      stride: tensor stride (a plain int).
    """
    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    stride: int = 1

    @property
    def capacity(self) -> int:
        return self.coords.shape[1]

    @property
    def batch_size(self) -> int:
        return self.coords.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    def replace(self, **changes) -> "SparseVoxels":
        return dataclasses.replace(self, **changes)

    def cat(self, other: "SparseVoxels") -> "SparseVoxels":
        """Feature concat of two tensors with identical coords."""
        if self.stride != other.stride:
            raise ValueError(f"cat of strides {self.stride} and {other.stride}")
        return self.replace(feats=torch.cat([self.feats, other.feats], dim=-1))
