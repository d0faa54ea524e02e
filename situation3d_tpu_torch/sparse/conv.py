"""Sparse convolution compute + normalization modules (port of the forward
path of ``situation3d_tpu/sparse/conv.py``).

A sparse conv is a sum over kernel offsets of ``gather -> matmul`` over a
precomputed neighbor map; every map-driven conv goes through
``ops/cuda/fused_conv.py`` (CUDA kernel on the card, its plain version on
the CPU). Parameters keep the reference's names and layouts (conv kernels
``[K, C_in, C_out]``) and are float32; ``dtype`` is the compute dtype.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from situation3d_tpu_torch.ops.cuda.fused_conv import fused_sparse_conv
from situation3d_tpu_torch.sparse.tensor import SparseVoxels


def sparse_conv_apply(feats: torch.Tensor, nbr_idx: torch.Tensor,
                      kernel: torch.Tensor) -> torch.Tensor:
    """Gather-matmul sparse convolution, forward only.

    Args:
      feats:   [B, V_in, C_in] input features (padding rows must be zero).
      nbr_idx: int32 [B, V_out, K] neighbor map (misses, ``V_in`` or ``-1``,
        gather zeros).
      kernel:  [K, C_in, C_out] weights.
    Returns [B, V_out, C_out] (float32 accumulated, cast back to feats.dtype).
    """
    return fused_sparse_conv(feats, nbr_idx, kernel).to(feats.dtype)


def _fan_in_normal_(w: torch.Tensor, fan_in: int) -> None:
    """He-style fan-in init: normal truncated at two standard deviations,
    rescaled so the truncated distribution has variance ``2 / fan_in``."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class SparseConv(nn.Module):
    """Sparse convolution over a precomputed neighbor map (bias-free; BN
    supplies the bias). The direction (down, same, transpose) lives entirely
    in the map."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(kernel_volume, in_channels, out_channels))
        _fan_in_normal_(self.kernel, kernel_volume * in_channels)

    def forward(self, x: SparseVoxels, nbr_idx, out_coords, out_mask,
                out_stride) -> SparseVoxels:
        out = sparse_conv_apply(x.feats.to(self.dtype), nbr_idx, self.kernel)
        out = out * out_mask[..., None]
        return SparseVoxels(coords=out_coords, feats=out, mask=out_mask,
                            stride=out_stride)


class SparseConv1x1(nn.Module):
    """kernel_size=1 sparse conv == per-voxel dense projection (BasicBlock
    downsample path). A plain large product: left to ``torch.matmul``."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels))
        _fan_in_normal_(self.kernel, in_channels)

    def forward(self, x: SparseVoxels) -> SparseVoxels:
        out = torch.matmul(x.feats.to(self.dtype), self.kernel.to(self.dtype))
        return x.replace(feats=out * x.mask[..., None])


class SparseBatchNorm(nn.Module):
    """Masked batch norm over valid voxels, evaluation form: running
    statistics, ``(x - mean) * rsqrt(var + eps) * scale + bias`` in float32,
    masked rows zeroed, then cast. (The scene encoder always runs it this
    way; batch statistics come with the training slice.)"""

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: SparseVoxels) -> SparseVoxels:
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        out = (x.feats.float() - self.mean) * inv + self.bias
        return x.replace(feats=(out * x.mask[..., None]).to(self.dtype))


def sparse_relu(x: SparseVoxels) -> SparseVoxels:
    return x.replace(feats=torch.relu(x.feats))
