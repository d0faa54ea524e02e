"""OPT causal language model (port of ``situation3d_tpu/models/opt.py``).

A decoder-only transformer: learned positional embeddings at offset 2 read
at the attention-mask cumsum (a left-padded prompt's first real token is
position 0), pre-LN blocks, ReLU MLPs, a final layer norm and an LM head
tied to the token embeddings. A prefix of embeddings (the BLIP-2 query
tokens) may precede the token ids. ``decode_prefix`` / ``decode_step`` run
against a list of ``OPTLayerCache`` (``init_cache``), whose pad slots stay
masked as keys for good; ``opt_greedy_decode`` generates after a [prefix ;
left-padded prompt].

Parameters are float32, compute runs in ``dtype``; attention is product,
float32 softmax, product, with additive ``NEG_INF`` masks as the reference
adds them. The cache holds the slots written so far: the reference attends
over ``max_position`` slots and masks the unwritten ones, whose softmax
weight is exactly 0 in float32, so attending over the written slots alone
gives the same values.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.models.layers import Dense, Embed, LayerNorm, materialise

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 2560            # opt-2.7b
    num_layers: int = 32
    num_heads: int = 32
    ffn_dim: int = 10240
    max_position: int = 2048
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 2
    eos_token_id: int = 2
    pos_offset: int = 2                # OPTLearnedPositionalEmbedding's offset

    @staticmethod
    def tiny(**kw) -> "OPTConfig":
        base = dict(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, ffn_dim=64, max_position=64)
        base.update(kw)
        return OPTConfig(**base)


class OPTLayerCache:
    """One layer's keys, values and per-slot key validity, ``capacity``
    slots, ``index`` of them written."""

    def __init__(self, B: int, heads: int, capacity: int, head_dim: int,
                 dtype: torch.dtype, device):
        self.k = torch.zeros(B, heads, capacity, head_dim, dtype=dtype, device=device)
        self.v = torch.zeros_like(self.k)
        self.valid = torch.zeros(B, capacity, dtype=torch.bool, device=device)
        self.index = 0

    def append(self, k, v, step_mask=None):
        """Write ``L`` new slots; returns (keys, values, additive bias
        [B, 1, L, written]) over the slots written so far."""
        i, L = self.index, k.shape[2]
        n = i + L
        if n > self.k.shape[2]:
            raise ValueError(f"OPT cache overflow: {n} slots > capacity {self.k.shape[2]}")
        self.k[:, :, i:n] = k
        self.v[:, :, i:n] = v
        self.valid[:, i:n] = True if step_mask is None else step_mask.bool()
        self.index = n
        dev = k.device
        causal = torch.arange(n, device=dev)[None, :] <= (i + torch.arange(L, device=dev))[:, None]
        ok = causal[None] & self.valid[:, None, :n]                              # [B, L, n]
        bias = torch.where(ok, torch.zeros((), device=dev), NEG_INF)[:, None]
        return self.k[:, :, :n], self.v[:, :, :n], bias


class OPTAttention(nn.Module):
    """Biased multi-head attention, causal, with an optional decode cache."""

    def __init__(self, cfg: OPTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = cfg.hidden_size
        self.cfg, self.dtype = cfg, dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(H, H, dtype))

    def forward(self, hidden, attn_bias=None, cache: Optional[OPTLayerCache] = None,
                step_mask=None) -> torch.Tensor:
        cfg = self.cfg
        B, L, C = hidden.shape
        h, d = cfg.num_heads, C // cfg.num_heads

        def split(x):
            return x.reshape(B, -1, h, d).transpose(1, 2)

        q = split(self.q_proj(hidden)) * (d ** -0.5)
        k, v = split(self.k_proj(hidden)), split(self.v_proj(hidden))
        if cache is not None:
            k, v, attn_bias = cache.append(k, v, step_mask)
        scores = torch.matmul(q, k.transpose(-1, -2))
        if attn_bias is not None:
            scores = scores + attn_bias.to(scores.dtype)
        att = F.softmax(scores.float(), dim=-1).to(self.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, L, C)
        return self.out_proj(out)


class OPTDecoderLayer(nn.Module):
    """Pre-LN decoder block with a ReLU MLP."""

    def __init__(self, cfg: OPTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn_layer_norm = LayerNorm(H, eps, dtype)
        self.self_attn = OPTAttention(cfg, dtype)
        self.final_layer_norm = LayerNorm(H, eps, dtype)
        self.fc1 = Dense(H, cfg.ffn_dim, dtype)
        self.fc2 = Dense(cfg.ffn_dim, H, dtype)

    def forward(self, x, attn_bias=None, cache=None, step_mask=None) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), attn_bias, cache, step_mask)
        return x + self.fc2(F.relu(self.fc1(self.final_layer_norm(x))))


class OPTForCausalLM(nn.Module):
    """OPT decoder + tied LM head, built on ``device`` with seeded weights
    (``init_blip2_weights``). ``device="meta"`` leaves it unmaterialised for
    a parent that places and fills it (``Blip2OPT``)."""

    def __init__(self, cfg: OPTConfig, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        H = cfg.hidden_size
        self.cfg, self.dtype = cfg, dtype
        with torch.device("meta"):
            self.embed_tokens = Embed(cfg.vocab_size, H, dtype)
            self.embed_positions = Embed(cfg.max_position + cfg.pos_offset, H, dtype)
            for i in range(cfg.num_layers):
                self.add_module(f"layer{i}", OPTDecoderLayer(cfg, dtype))
            self.final_norm = LayerNorm(H, cfg.layer_norm_eps, dtype)
        materialise(self, device, seed)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def layers(self) -> List[OPTDecoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.cfg.num_layers)]

    def _logits(self, x) -> torch.Tensor:
        x = self.final_norm(x)
        return F.linear(x.to(self.dtype), self.embed_tokens.weight.to(self.dtype))

    def _positions(self, attention_mask) -> torch.Tensor:
        """Position embeddings at ``cumsum(mask) * mask - 1 + offset``."""
        m = attention_mask.long()
        pos = torch.cumsum(m, dim=1) * m - 1
        return self.embed_positions(pos.clamp(min=0) + self.cfg.pos_offset)

    def forward(self, input_ids, attention_mask, prefix_embeds=None, prefix_mask=None
                ) -> torch.Tensor:
        """-> logits [B, P + L, V]; the prefix, if any, takes the first P
        positions."""
        x = self.embed_tokens(input_ids)
        mask = attention_mask
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(self.dtype), x], dim=1)
            pm = (torch.ones(prefix_embeds.shape[:2], dtype=attention_mask.dtype,
                             device=attention_mask.device)
                  if prefix_mask is None else prefix_mask)
            mask = torch.cat([pm, attention_mask], dim=1)
        x = x + self._positions(mask)
        L = x.shape[1]
        pos = torch.arange(L, device=x.device)
        causal = pos[None, :] <= pos[:, None]
        ok = causal[None, None] & mask.bool()[:, None, None, :]
        bias = torch.where(ok, torch.zeros((), device=x.device), NEG_INF)
        for layer in self.layers():
            x = layer(x, bias)
        return self._logits(x)

    def init_cache(self, B: int, capacity: Optional[int] = None) -> List[OPTLayerCache]:
        cfg = self.cfg
        return [OPTLayerCache(B, cfg.num_heads, capacity or cfg.max_position,
                              cfg.hidden_size // cfg.num_heads, self.dtype, self.device)
                for _ in range(cfg.num_layers)]

    def decode_prefix(self, prefix_embeds, cache: List[OPTLayerCache]) -> torch.Tensor:
        """Prime the cache with the embedding prefix; its logits."""
        P = prefix_embeds.shape[1]
        pos = torch.arange(P, device=prefix_embeds.device)[None] + self.cfg.pos_offset
        x = prefix_embeds.to(self.dtype) + self.embed_positions(pos)
        for layer, c in zip(self.layers(), cache):
            x = layer(x, cache=c)
        return self._logits(x)

    def decode_step(self, token_ids, positions, cache: List[OPTLayerCache],
                    step_mask=None) -> torch.Tensor:
        """Cached step(s): ``positions`` [B, L] position indices of
        ``token_ids``; ``step_mask`` [B, L] marks real tokens, the others stay
        masked as keys in every later step."""
        x = self.embed_tokens(token_ids) + self.embed_positions(positions + self.cfg.pos_offset)
        for layer, c in zip(self.layers(), cache):
            x = layer(x, cache=c, step_mask=step_mask)
        return self._logits(x)


def opt_causal_lm_loss(logits, targets) -> torch.Tensor:
    """The causal-LM loss: logits and targets shifted by one, mean
    cross-entropy over targets != -100 (prefix positions carry -100)."""
    lg = logits[:, :-1].float()
    tg = targets[:, 1:].long()
    keep = (tg != -100).float()
    per = torch.logsumexp(lg, dim=-1) - lg.gather(-1, tg.clamp(min=0)[..., None])[..., 0]
    return (per * keep).sum() / keep.sum().clamp(min=1.0)


@torch.no_grad()
def opt_greedy_decode(model: OPTForCausalLM, prefix_embeds, first_ids, max_len: int,
                      eos_id: int, pad_id: int, first_mask=None) -> torch.Tensor:
    """Greedy generation after a [prefix ; first tokens] prompt: prime the
    cache, then one argmax token at a time until every row has emitted
    ``eos_id`` or ``max_len`` tokens. ``first_ids`` [B, Lp] left-padded
    prompt ids with ``first_mask`` [B, Lp] marking real tokens (None: no
    padding); pad slots take no position and are never attended. Returns
    int64 [B, max_len], ``pad_id`` after a row's end."""
    dev = model.device
    prefix_embeds, first_ids = prefix_embeds.to(dev), first_ids.to(dev).long()
    B, P = prefix_embeds.shape[:2]
    Lp = first_ids.shape[1]
    m = (torch.ones(B, Lp, dtype=torch.long, device=dev) if first_mask is None
         else first_mask.to(dev).long())
    cache = model.init_cache(B, P + Lp + max_len)
    model.decode_prefix(prefix_embeds, cache)
    # the prompt's positions continue the prefix's over its real tokens; pad
    # slots sit at P - 1 and are masked
    prompt_pos = (P + torch.cumsum(m, dim=1) * m - 1).clamp(min=0)
    logits = model.decode_step(first_ids, prompt_pos, cache, step_mask=m)
    tok = logits[:, -1].argmax(-1)
    n_valid = m.sum(dim=1)
    out = torch.full((B, max_len), pad_id, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(max_len):
        if bool(done.all()):
            break
        nxt = torch.where(done, torch.full_like(tok, pad_id), tok)
        out[:, i] = nxt
        done = done | (tok == eos_id)
        logits = model.decode_step(nxt[:, None], (P + n_valid)[:, None] + i, cache)
        tok = logits[:, -1].argmax(-1)
    return out
