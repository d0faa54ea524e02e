"""Language encoders for SIG3D (port of ``situation3d_tpu/models/lang.py``):
an MPNet-style transformer, and the GloVe + LSTM encoder
(``model.lang_model=lstm``), in plain PyTorch. Situation ``s`` and question
``q`` are encoded separately with shared weights; outputs are ``[B, L, H]``
plus pad masks (True == padding). The reference's MPNet takes a
``deterministic`` flag and drops nowhere, so there is no dropout there in
training either; the LSTM encoder drops its embeddings in training. Which
layers train is the optimizer's business (``train/optim.py``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.config import LangConfig
from situation3d_tpu_torch.models.layers import Dense, Embed, LayerNorm, dropout
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


class OptimizedLSTMCell(nn.Module):
    """The reference's LSTM cell (flax ``OptimizedLSTMCell``) with its own
    leaves: input projections ``ii``, ``if``, ``ig``, ``io`` without bias and
    hidden projections ``hi``, ``hf``, ``hg``, ``ho`` with one, so the
    parameters (and what Adam trains) are the reference's.
    ``i, f, o = sigmoid(...)``, ``g = tanh(...)``, ``c' = f c + i g``,
    ``h' = o tanh(c')`` from a zero carry, in float32."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        for gate in "ifgo":
            self.add_module(f"i{gate}", Dense(input_size, hidden_size, bias=False))
            self.add_module(f"h{gate}", Dense(hidden_size, hidden_size))

    def _stacked(self, side: str):
        mods = [getattr(self, f"{side}{gate}") for gate in "ifgo"]
        w = torch.cat([m.weight for m in mods])
        return w, (torch.cat([m.bias for m in mods]) if side == "h" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, L, D]`` -> the hidden state at every step ``[B, L, H]``:
        one fused LSTM call (``torch.lstm``; cuDNN's on the card) on the
        stacked leaves, its input-side bias zero. cuDNN keeps what its
        backward needs only in training form, so that form is asked for
        whenever autograd records."""
        x = x.float()
        w_i, _ = self._stacked("i")
        w_h, b_h = self._stacked("h")
        h0 = x.new_zeros(1, x.shape[0], self.hidden_size)
        out, _, _ = torch.lstm(x, (h0, h0), (w_i, w_h, torch.zeros_like(b_h), b_h),
                               True, 1, 0.0, torch.is_grad_enabled(), False, True)
        return out


class LSTMLangEncoder(nn.Module):
    """Embedding dropout, then one LSTM over every position. The reference's
    ``nn.RNN(seq_lengths=...)`` returns the outputs of the whole scan (the
    lengths select only a final carry it does not return), so positions past
    a row's length run on as well; the caller masks them."""

    def __init__(self, input_size: int, hidden_size: int = 768, pdrop: float = 0.1):
        super().__init__()
        self.pdrop = pdrop
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(input_size, hidden_size)

    def forward(self, embs, train: bool = False, generator=None):
        return self.OptimizedLSTMCell_0(dropout(embs, self.pdrop, train, generator))


class GloveLSTMEncoder(nn.Module):
    """Token ids -> per-position LSTM states, zero at padding. The reference
    looks tokens up in a GloVe table; here ``word_embeddings`` is a table of
    the same width (``lang.vocab_size`` x ``lang.glove_dim``) that
    ``ckpt_compat`` fills."""

    def __init__(self, cfg: LangConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.word_embeddings = Embed(cfg.vocab_size, cfg.glove_dim, dtype)
        self.lstm_encoder = LSTMLangEncoder(cfg.glove_dim, cfg.hidden_size)

    def forward(self, input_ids, attention_mask, train: bool = False, generator=None):
        emb = self.word_embeddings(input_ids.to(torch.int64))
        out = self.lstm_encoder(emb, train, generator)
        return out * attention_mask[..., None].to(out.dtype)


class LangModule(nn.Module):
    """Encodes situation and question separately with shared weights.
    ``model``: "mpnet" or "lstm" (GloVe + LSTM). Returns (s_out, q_out,
    s_pad_mask, q_pad_mask); pad masks True at pads. ``train`` turns on the
    LSTM encoder's embedding dropout, its mask drawn from ``generator``."""

    def __init__(self, cfg: LangConfig, dtype: torch.dtype = torch.float32,
                 model: str = "mpnet"):
        super().__init__()
        if model == "lstm":
            self.encoder = GloveLSTMEncoder(cfg, dtype)
        elif model == "mpnet":
            self.encoder = MPNetEncoder(cfg, dtype)
        else:
            raise ValueError(f"unknown lang_model {model!r}")

    def _encode(self, ids, mask, train, generator):
        if isinstance(self.encoder, GloveLSTMEncoder):
            return self.encoder(ids, mask, train, generator)
        return self.encoder(ids, mask)

    def forward(self, s_ids, s_mask, q_ids, q_mask, train: bool = False, generator=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        if s_ids.shape == q_ids.shape:
            # one pass over [situations; questions]: rows do not interact, and
            # an eager forward pays per launch, not per row
            out = self._encode(torch.cat([s_ids, q_ids]), torch.cat([s_mask, q_mask]),
                               train, generator)
            s_out, q_out = out[:s_ids.shape[0]], out[s_ids.shape[0]:]
        else:
            s_out = self._encode(s_ids, s_mask, train, generator)
            q_out = self._encode(q_ids, q_mask, train, generator)
        return s_out, q_out, s_mask == 0, q_mask == 0
