"""Sinusoidal voxel position encoding of the 3D-LLM (port of
``situation3d_tpu/models/positional.py``).

``voxel_position_table`` is the reference's precomputed
``PositionalEncoding1D(1408 // 3)`` table over 256 positions: interleaved
sin/cos over an even channel count, truncated back to the odd 469 channels.
``voxel_position_embedding`` looks it up per xyz axis and concatenates,
zero-padding the last 1407 -> 1408 channel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def voxel_position_table(channels: int, n_pos: int = 256) -> np.ndarray:
    """[n_pos, channels] interleaved sin/cos table (float32)."""
    c2 = channels + (channels % 2)  # round up to even like the reference lib
    inv_freq = 1.0 / (10000 ** (np.arange(0, c2, 2, dtype=np.float64) / c2))
    pos = np.arange(n_pos, dtype=np.float64)[:, None]
    ang = pos * inv_freq[None, :]
    table = np.zeros((n_pos, c2), np.float32)
    table[:, 0::2] = np.sin(ang)
    table[:, 1::2] = np.cos(ang)
    return table[:, :channels]


def voxel_position_embedding(pc: torch.Tensor, feat_dim: int,
                             table: torch.Tensor) -> torch.Tensor:
    """Per-axis table lookup, concatenated into [B, N, feat_dim].

    pc: integer voxel coords [B, N, 3], clipped into [0, n_pos - 1].
    """
    n_pos = table.shape[0]
    idx = pc.long().clamp(0, n_pos - 1)
    emb = torch.cat([table[idx[..., i]] for i in range(3)], dim=-1)
    pad = feat_dim - emb.shape[-1]
    if pad > 0:
        emb = F.pad(emb, (0, pad))
    return emb[..., :feat_dim]
