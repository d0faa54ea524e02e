"""MCAN-style attention fusion modules (port of
``situation3d_tpu/models/mcan.py``). Pad masks are True where a position is
padding; masked logits get ``-1e9`` before a float32 softmax. ``train`` turns
on dropout at the places the reference drops (after the MLP's GELU, on the
attention weights, on each residual branch), its masks drawn from
``generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.models.layers import Dense, dropout

NEG_INF = -1e9


class MCANLayerNorm(nn.Module):
    """``a * (x - mean) / (std + eps) + b`` with the UNBIASED std (n-1) and
    eps added OUTSIDE the sqrt — not ``nn.LayerNorm``."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        H = xf.shape[-1]
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().sum(dim=-1, keepdim=True) / (H - 1)
        out = self.scale * (xf - mean) / (var.sqrt() + self.epsilon) + self.bias
        return out.to(self.dtype)


class MLP(nn.Module):
    """FC(+GELU+dropout) -> Linear."""

    def __init__(self, in_size: int, mid_size: int, out_size: int,
                 dtype: torch.dtype = torch.float32, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.fc = Dense(in_size, mid_size, dtype)
        self.linear = Dense(mid_size, out_size, dtype)

    def forward(self, x, train: bool = False, generator=None):
        return self.linear(dropout(F.gelu(self.fc(x)), self.pdrop, train, generator))


class AttFlat(nn.Module):
    """Attention-weighted flatten of a sequence (softmax over the sequence
    axis)."""

    def __init__(self, hidden_size: int, flat_mlp_size: int = 256,
                 flat_glimpses: int = 1, flat_out_size: int = 512,
                 dtype: torch.dtype = torch.float32, pdrop: float = 0.1):
        super().__init__()
        self.mlp = MLP(hidden_size, flat_mlp_size, flat_glimpses, dtype, pdrop)
        self.linear_merge = Dense(hidden_size * flat_glimpses, flat_out_size, dtype)

    def forward(self, x, pad_mask: Optional[torch.Tensor], train: bool = False,
                generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        att = self.mlp(x, train, generator)                     # [B, L, glimpses]
        if pad_mask is not None:
            att = att.masked_fill(pad_mask[..., None], NEG_INF)
        att = torch.softmax(att, dim=1)
        flat = torch.matmul(att.transpose(1, 2), x).reshape(x.shape[0], -1)
        return self.linear_merge(flat), att


class MHAtt(nn.Module):
    """Multi-head attention as explicit matmul + softmax."""

    def __init__(self, hidden_size: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32, pdrop: float = 0.1):
        super().__init__()
        self.hidden_size, self.num_heads, self.dtype = hidden_size, num_heads, dtype
        self.pdrop = pdrop
        self.linear_v = Dense(hidden_size, hidden_size, dtype)
        self.linear_k = Dense(hidden_size, hidden_size, dtype)
        self.linear_q = Dense(hidden_size, hidden_size, dtype)
        self.linear_merge = Dense(hidden_size, hidden_size, dtype)

    def forward(self, v, k, q, pad_mask: Optional[torch.Tensor],
                train: bool = False, generator=None):
        B = q.shape[0]
        h, d = self.num_heads, self.hidden_size // self.num_heads

        def heads(x):
            return x.view(B, -1, h, d).transpose(1, 2)

        vh, kh, qh = heads(self.linear_v(v)), heads(self.linear_k(k)), heads(self.linear_q(q))
        scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(d)
        if pad_mask is not None:
            scores = scores.masked_fill(pad_mask[:, None, None, :], NEG_INF)
        att = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        att = dropout(att, self.pdrop, train, generator)
        out = torch.matmul(att, vh).transpose(1, 2).reshape(B, -1, self.hidden_size)
        return self.linear_merge(out)


class FFN(nn.Module):
    """4x-expansion feed-forward."""

    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32,
                 pdrop: float = 0.1):
        super().__init__()
        self.mlp = MLP(hidden_size, hidden_size * 4, hidden_size, dtype, pdrop)

    def forward(self, x, train: bool = False, generator=None):
        return self.mlp(x, train, generator)


class SA(nn.Module):
    """Self-attention block."""

    def __init__(self, hidden_size: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.mhatt = MHAtt(hidden_size, num_heads, dtype, pdrop)
        self.norm1 = MCANLayerNorm(hidden_size, dtype=dtype)
        self.ffn = FFN(hidden_size, dtype, pdrop)
        self.norm2 = MCANLayerNorm(hidden_size, dtype=dtype)

    def forward(self, x, pad_mask, train: bool = False, generator=None):
        def drop(t):
            return dropout(t, self.pdrop, train, generator)
        x = self.norm1(x + drop(self.mhatt(x, x, x, pad_mask, train, generator)))
        return self.norm2(x + drop(self.ffn(x, train, generator)))


class SGA(nn.Module):
    """Self- then cross-attention block: ``x`` attends to itself, then
    to ``y`` (keys/values from ``y``)."""

    def __init__(self, hidden_size: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.mhatt1 = MHAtt(hidden_size, num_heads, dtype, pdrop)
        self.norm1 = MCANLayerNorm(hidden_size, dtype=dtype)
        self.mhatt2 = MHAtt(hidden_size, num_heads, dtype, pdrop)
        self.norm2 = MCANLayerNorm(hidden_size, dtype=dtype)
        self.ffn = FFN(hidden_size, dtype, pdrop)
        self.norm3 = MCANLayerNorm(hidden_size, dtype=dtype)

    def forward(self, x, y, x_pad_mask, y_pad_mask, train: bool = False,
                generator=None):
        def drop(t):
            return dropout(t, self.pdrop, train, generator)
        x = self.norm1(x + drop(self.mhatt1(x, x, x, x_pad_mask, train, generator)))
        x = self.norm2(x + drop(self.mhatt2(y, y, x, y_pad_mask, train, generator)))
        return self.norm3(x + drop(self.ffn(x, train, generator)))
