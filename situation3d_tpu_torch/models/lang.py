"""Language encoder for SIG3D (port of ``situation3d_tpu/models/lang.py``):
an MPNet-style transformer written in plain PyTorch. Situation ``s`` and
question ``q`` are encoded separately with shared weights; outputs are
``[B, L, H]`` plus pad masks (True == padding). The reference's MPNet takes
a ``deterministic`` flag and drops nowhere, so there is no dropout here in
training either; which layers train is the optimizer's business
(``train/optim.py``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.config import LangConfig
from situation3d_tpu_torch.models.layers import Dense, Embed, LayerNorm
from situation3d_tpu_torch.models.relpos import (relative_position_bucket,
                                                 relative_position_matrix)


class MPNetSelfAttention(nn.Module):
    def __init__(self, cfg: LangConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        H = cfg.hidden_size
        self.q, self.k, self.v, self.o = (Dense(H, H, dtype) for _ in range(4))

    def forward(self, hidden, attn_mask, position_bias):
        B, L, H = hidden.shape
        h = self.cfg.num_heads
        d = H // h

        def heads(x):
            return x.view(B, L, h, d).transpose(1, 2)

        q, k, v = heads(self.q(hidden)), heads(self.k(hidden)), heads(self.v(hidden))
        # explicit matmul + softmax (f32), the reference's arithmetic
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        scores = scores + position_bias.to(scores.dtype)
        scores = scores.masked_fill(attn_mask[:, None, None, :], -1e9)
        att = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, L, H)
        return self.o(out)


class MPNetLayer(nn.Module):
    def __init__(self, cfg: LangConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        self.attention = MPNetSelfAttention(cfg, dtype)
        self.attention_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)
        self.intermediate = Dense(H, cfg.intermediate_size, dtype)
        self.output = Dense(cfg.intermediate_size, H, dtype)
        self.output_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)

    def forward(self, hidden, attn_mask, position_bias):
        a = self.attention(hidden, attn_mask, position_bias)
        hidden = self.attention_norm(hidden + a)
        out = self.output(F.gelu(self.intermediate(hidden)))
        return self.output_norm(hidden + out)


class MPNetEncoder(nn.Module):
    """MPNet: BERT body + one relative position bias shared by all layers;
    padding-aware position ids (pad_token_id offset)."""

    def __init__(self, cfg: LangConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        H = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, H, dtype)
        self.position_embeddings = Embed(cfg.max_position, H, dtype)
        self.emb_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)
        self.relative_attention_bias = Embed(
            cfg.relative_attention_num_buckets, cfg.num_heads, torch.float32)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", MPNetLayer(cfg, dtype))

    def forward(self, input_ids, attention_mask):
        cfg = self.cfg
        L = input_ids.shape[1]
        am = attention_mask.to(torch.int64)
        position_ids = torch.cumsum(am, dim=1) * am + cfg.pad_token_id
        hidden = self.emb_norm(self.word_embeddings(input_ids.to(torch.int64))
                               + self.position_embeddings(position_ids))

        rp = relative_position_matrix(L, L, device=input_ids.device)
        buckets = relative_position_bucket(
            rp, True, cfg.relative_attention_num_buckets, 128)
        bias = self.relative_attention_bias(buckets)           # [L, L, heads] f32
        position_bias = bias.permute(2, 0, 1)[None]

        pad_mask = attention_mask == 0
        for i in range(cfg.num_layers):
            hidden = getattr(self, f"layer{i}")(hidden, pad_mask, position_bias)
        return hidden


class LangModule(nn.Module):
    """Encodes situation and question separately with shared weights.
    Returns (s_out, q_out, s_pad_mask, q_pad_mask); pad masks True at pads."""

    def __init__(self, cfg: LangConfig, dtype: torch.dtype = torch.float32,
                 model: str = "mpnet"):
        super().__init__()
        if model == "lstm":
            raise NotImplementedError(
                "lang_model='lstm' (GloVe+LSTM encoder) is not ported yet: it "
                "comes with the training/CLI slice; use 'mpnet'")
        if model != "mpnet":
            raise ValueError(f"unknown lang_model {model!r}")
        self.encoder = MPNetEncoder(cfg, dtype)

    def forward(self, s_ids, s_mask, q_ids, q_mask
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        if s_ids.shape == q_ids.shape:
            # one pass over [situations; questions]: rows do not interact, and
            # an eager forward pays per launch, not per row
            out = self.encoder(torch.cat([s_ids, q_ids]), torch.cat([s_mask, q_mask]))
            s_out, q_out = out[:s_ids.shape[0]], out[s_ids.shape[0]:]
        else:
            s_out, q_out = self.encoder(s_ids, s_mask), self.encoder(q_ids, q_mask)
        return s_out, q_out, s_mask == 0, q_mask == 0
