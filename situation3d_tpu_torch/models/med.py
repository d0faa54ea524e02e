"""MED, BLIP-1's multimodal encoder-decoder BERT (port of
``situation3d_tpu/models/med.py``).

A post-LN BERT whose layers can cross-attend into a vision-encoder width,
switched at call time by ``mode``:

- ``"text"``: self-attention only, BLIP-1's ITC text encoder;
- ``"multimodal"`` (or ``"fusion"``): cross-attention into
  ``encoder_hidden_states`` in every layer that has one, the ITM /
  captioning pass.

``is_decoder`` makes the self-attention causal; ``MedBertLMHeadModel`` is
that decoder with the untied LM head, and its ``lm_loss`` shifts by one and
label-smooths 0.1. Masks replace scores with ``NEG_INF`` as the reference
does; attention is product, float32 softmax, product. Generation re-runs the
masked full pass (no cache), as in the reference. The models are built on
their device from a seed (``device="meta"`` leaves a part for its parent).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.models.layers import Dense, Embed, LayerNorm, materialise

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class MedConfig:
    """The BertConfig fields MED reads (bert-base with cross-attention into
    the ViT width)."""
    vocab_size: int = 30524            # bert-base + [DEC] / [ENC] tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    add_type_embeddings: bool = True
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    encoder_width: int = 768           # vision width for cross-attention
    add_cross_attention: bool = True
    is_decoder: bool = False           # causal self-attention (the LM head's decoder)


class MedAttention(nn.Module):
    """Self- or cross-attention + output dense + residual LayerNorm."""

    def __init__(self, cfg: MedConfig, is_cross: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        kv_in = cfg.encoder_width if is_cross else H
        self.cfg, self.dtype = cfg, dtype
        self.query = Dense(H, H, dtype)
        self.key = Dense(kv_in, H, dtype)
        self.value = Dense(kv_in, H, dtype)
        self.out_dense = Dense(H, H, dtype)
        self.out_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)

    def forward(self, hidden, kv=None, kv_mask=None, causal: bool = False) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = hidden.shape
        h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        kv_src = hidden if kv is None else kv

        def split(x):
            return x.reshape(B, -1, h, d).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(kv_src)), split(self.value(kv_src))
        scores = torch.matmul(q, k.transpose(-1, -2)) / (d ** 0.5)
        neg = torch.tensor(NEG_INF, dtype=scores.dtype, device=scores.device)
        if kv_mask is not None:
            scores = torch.where(kv_mask[:, None, None, :].bool(), scores, neg)
        if causal:
            cm = torch.tril(torch.ones(L, scores.shape[-1], dtype=torch.bool,
                                       device=scores.device))
            scores = torch.where(cm[None, None], scores, neg)
        att = F.softmax(scores.float(), dim=-1).to(self.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, L, cfg.hidden_size)
        return self.out_norm(hidden + self.out_dense(out))


class MedLayer(nn.Module):
    """Self-attention -> [cross-attention] -> FFN, each residual + post-LN."""

    def __init__(self, cfg: MedConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        self.cfg = cfg
        self.attention = MedAttention(cfg, dtype=dtype)
        self.crossattention = (MedAttention(cfg, is_cross=True, dtype=dtype)
                               if cfg.add_cross_attention else None)
        self.intermediate = Dense(H, cfg.intermediate_size, dtype)
        self.output = Dense(cfg.intermediate_size, H, dtype)
        self.output_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)

    def forward(self, hidden, attn_mask, enc_states, enc_mask, mode: str,
                causal: bool) -> torch.Tensor:
        hidden = self.attention(hidden, kv_mask=attn_mask, causal=causal)
        if mode in ("multimodal", "fusion") and self.crossattention is not None:
            hidden = self.crossattention(hidden, kv=enc_states, kv_mask=enc_mask)
        inter = F.gelu(self.intermediate(hidden), approximate="none")
        return self.output_norm(hidden + self.output(inter))


class MedBertModel(nn.Module):
    """BertModel: embeddings -> layers -> (tanh pooler over the CLS state).
    ``forward`` returns ``(sequence_output, pooled_output or None)``."""

    def __init__(self, cfg: MedConfig, add_pooling_layer: bool = True,
                 dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0):
        super().__init__()
        H = cfg.hidden_size
        self.cfg, self.dtype = cfg, dtype
        with torch.device("meta"):
            self.word_embeddings = Embed(cfg.vocab_size, H, dtype)
            self.position_embeddings = nn.Parameter(
                torch.empty(cfg.max_position_embeddings, H))
            self.token_type_embeddings = (Embed(cfg.type_vocab_size, H, dtype)
                                          if cfg.add_type_embeddings else None)
            self.emb_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)
            for i in range(cfg.num_layers):
                self.add_module(f"layer{i}", MedLayer(cfg, dtype))
            self.pooler = Dense(H, H, dtype) if add_pooling_layer else None
        materialise(self, device, seed)

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                mode: str = "multimodal", inputs_embeds=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.word_embeddings(input_ids)
        L = inputs_embeds.shape[1]
        x = inputs_embeds + self.position_embeddings[None, :L].to(self.dtype)
        if self.token_type_embeddings is not None and token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        x = self.emb_norm(x)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer{i}")(x, attention_mask, encoder_hidden_states,
                                           encoder_attention_mask, mode, cfg.is_decoder)
        pooled = torch.tanh(self.pooler(x[:, 0])) if self.pooler is not None else None
        return x, pooled


class MedLMHead(nn.Module):
    """Transform (dense + GELU + LayerNorm), then the untied vocabulary
    decoder."""

    def __init__(self, cfg: MedConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        self.transform = Dense(H, H, dtype)
        self.transform_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)
        self.decoder = Dense(H, cfg.vocab_size, dtype)

    def forward(self, hidden) -> torch.Tensor:
        x = self.transform_norm(F.gelu(self.transform(hidden), approximate="none"))
        return self.decoder(x)


class MedBertLMHeadModel(nn.Module):
    """BertLMHeadModel: the causal MED decoder + LM head; ``forward``
    returns logits [B, L, vocab]."""

    def __init__(self, cfg: MedConfig, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        with torch.device("meta"):
            self.bert = MedBertModel(dataclasses.replace(cfg, is_decoder=True),
                                     add_pooling_layer=False, dtype=dtype, device="meta")
            self.cls = MedLMHead(cfg, dtype)
        materialise(self, device, seed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                mode: str = "multimodal") -> torch.Tensor:
        seq, _ = self.bert(input_ids, attention_mask, token_type_ids=token_type_ids,
                           encoder_hidden_states=encoder_hidden_states,
                           encoder_attention_mask=encoder_attention_mask, mode=mode)
        return self.cls(seq)

    @staticmethod
    def lm_loss(logits, labels, smoothing: float = 0.1) -> torch.Tensor:
        """Shift-by-one label-smoothed cross-entropy over ``labels != -100``."""
        lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = labels[:, 1:].long()
        valid = tgt != -100
        nll = -lp.gather(-1, torch.where(valid, tgt, 0)[..., None])[..., 0]
        loss = (1.0 - smoothing) * nll + smoothing * -lp.mean(dim=-1)
        return torch.where(valid, loss, 0.0).sum() / valid.sum().clamp(min=1)
