"""Q-Former, BLIP-2's querying transformer (port of
``situation3d_tpu/models/qformer.py``).

The 3D path's configuration of the reference's modified BERT: learned query
tokens only (no word or position embeddings), cross-attention into the
scene features in every ``cross_attention_freq``-th layer, and only the
query FFN (``intermediate_query`` / ``output_query``). Post-LN layers,
LayerNorm eps 1e-12, keys masked with ``NEG_INF = -1e9``, the softmax in
float32. Module paths equal the reference's tree paths
(``layer0.crossattention.key``), so ``ckpt_compat/from_jax.py`` maps them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.config import QFormerConfig
from situation3d_tpu_torch.models.layers import Dense, LayerNorm

NEG_INF = -1e9


class BertSelfAttentionOut(nn.Module):
    """Attention -> output dense -> residual LayerNorm (post-LN BERT)."""

    def __init__(self, cfg: QFormerConfig, kv_width: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        self.cfg, self.dtype = cfg, dtype
        self.query = Dense(H, H, dtype)
        self.key = Dense(kv_width or H, H, dtype)
        self.value = Dense(kv_width or H, H, dtype)
        self.out_dense = Dense(H, H, dtype)
        self.out_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)

    def forward(self, hidden: torch.Tensor, kv: Optional[torch.Tensor] = None,
                kv_mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``kv_mask`` [B, K] masks keys; ``attn_bias`` [B, 1|h, L, K] is an
        additive mask."""
        cfg = self.cfg
        B, L, _ = hidden.shape
        h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        kv_src = hidden if kv is None else kv

        def split(x):
            return x.reshape(B, -1, h, d).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(kv_src)), split(self.value(kv_src))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        if kv_mask is not None:
            scores = torch.where(kv_mask[:, None, None, :].bool(), scores,
                                 torch.tensor(NEG_INF, dtype=scores.dtype, device=scores.device))
        if attn_bias is not None:
            scores = scores + attn_bias.to(scores.dtype)
        att = F.softmax(scores.float(), dim=-1).to(self.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, L, cfg.hidden_size)
        return self.out_norm(hidden + self.out_dense(out))


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        self.dtype = dtype
        self.attention = BertSelfAttentionOut(cfg, dtype=dtype)
        self.crossattention = (BertSelfAttentionOut(cfg, cfg.encoder_width, dtype)
                               if has_cross_attention else None)
        self.intermediate_query = Dense(H, cfg.intermediate_size, dtype)
        self.output_query = Dense(cfg.intermediate_size, H, dtype)
        self.output_query_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)

    def forward(self, hidden, enc_states, enc_mask):
        hidden = self.attention(hidden)
        if self.crossattention is not None:
            hidden = self.crossattention(hidden, kv=enc_states, kv_mask=enc_mask)
        inter = F.gelu(self.intermediate_query(hidden), approximate="none")
        return self.output_query_norm(hidden + self.output_query(inter))


class QFormer(nn.Module):
    """Query tokens -> BERT layers with periodic cross-attention."""

    def __init__(self, cfg: QFormerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.query_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_query_tokens, cfg.hidden_size))
        self.emb_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", QFormerLayer(
                cfg, has_cross_attention=(i % cfg.cross_attention_freq == 0), dtype=dtype))

    def forward(self, enc_states: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = enc_states.shape[0]
        hidden = self.query_tokens.expand(B, -1, -1).to(self.dtype)
        hidden = self.emb_norm(hidden)
        for i in range(cfg.num_layers):
            hidden = getattr(self, f"layer{i}")(hidden, enc_states, enc_mask)
        return hidden
