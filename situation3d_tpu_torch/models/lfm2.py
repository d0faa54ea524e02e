"""LFM2-MoE, a decoder-only causal LM with two kinds of sequence mixer and
two kinds of feed-forward (Liquid AI's ``lfm2_moe``, as Hugging Face's
``Lfm2Moe`` modelling code writes it). Sized for LFM2-24B-A2B.

A layer is ``h = x + mixer(operator_norm(x))``, then ``y = h +
ff(ffn_norm(h))``, RMS norms ``x * rsqrt(mean x^2 + eps) * w``.

- ``conv`` mixer (30 of the 40 layers): ``B, C, x~ = chunk3(in_proj(x))``,
  ``out_proj(C * causal_depthwise_conv(B * x~))``, a kernel of
  ``conv_L_cache`` taps and no bias. In decode its state is the last
  ``conv_L_cache`` values of ``B * x~`` a channel.
- ``full_attention`` mixer (10 layers): GQA, RMS norms over each head of q
  and k (``q_layernorm``, ``k_layernorm``) before RoPE (rotate-half, theta
  from the config), a causal softmax at ``1/sqrt(head_dim)``, ``out_proj``.
  In decode its state is a KV cache.
- feed-forward: the first ``num_dense_layers`` a dense SwiGLU
  ``w2(silu(w1 x) * w3 x)``; the rest a mixture of experts:
  ``s = sigmoid(gate(x))``, the experts ``top_k(s + expert_bias)``, each
  weighted by its own ``s`` over the sum of the chosen (+1e-6), times
  ``routed_scaling_factor``; ``ops/cuda/moe_experts.py`` runs the experts.
- ``embedding_norm`` after the last layer, then the head, tied to the token
  embedding.

Departures from the modelling code, each for agreement with a float32
reading: parameters are held in ``param_dtype`` (bfloat16 for the published
model) and products run in ``dtype``, but the residual stream, the norms,
the depthwise conv, RoPE and the attention scores and softmax are float32;
the router (the gate's product, the sigmoid, the bias, the top-k and the
normalisation) is float32 and its parameters are held in float32, since in
bfloat16 near-ties would flip experts; the KV cache holds ``dtype`` values,
and a prefill attends over its keys rounded alike.

Batches are left-padded: a row's [prefix ; prompt] ends at the last
position, its real positions are contiguous, RoPE positions count real
positions only, pad keys are masked, the conv sees zeros before the first
real position, and pad tokens are routed to no expert. So a row computes
what it would alone. Its :class:`DecodeState` holds both kinds of decode
state side by side: conv states ``[B, hidden, conv_L_cache]`` (float32) in
the conv layers and ``slots`` KV positions a row in the attention layers, the
prefix right-aligned to ``prefix_slots`` and decode step ``i`` writing slot
``prefix_slots + i``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.models.layers import Dense, Embed
from situation3d_tpu_torch.ops.cuda import moe_experts as moe_ops

NEG_INF = -1e9
LFM2_24B_LAYER_TYPES = tuple(
    ["conv", "conv", "full_attention"] + ["conv", "conv", "conv", "full_attention"] * 9
    + ["conv"])


@dataclass
class LFM2Config:
    """LFM2-MoE; the defaults are LFM2-24B-A2B's published ``config.json``."""
    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 11776
    moe_intermediate_size: int = 1536
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    layer_types: Tuple[str, ...] = field(default_factory=lambda: LFM2_24B_LAYER_TYPES)
    num_dense_layers: int = 2
    num_experts: int = 64
    num_experts_per_tok: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    use_expert_bias: bool = True
    norm_eps: float = 1e-5
    conv_L_cache: int = 3
    conv_bias: bool = False
    rope_theta: float = 1e6
    max_position_embeddings: int = 128000
    tie_embedding: bool = True
    bos_token_id: int = 1
    eos_token_id: int = 7
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw) -> "LFM2Config":
        """A CPU-sized model with every kind of layer: conv, attention, dense
        and expert feed-forwards."""
        base = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
                    moe_intermediate_size=16, num_hidden_layers=5, num_attention_heads=4,
                    num_key_value_heads=2, num_dense_layers=1, num_experts=6,
                    num_experts_per_tok=2,
                    layer_types=("conv", "full_attention", "conv", "conv", "full_attention"))
        base.update(kw)
        return cls(**base)


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """float32 out, whatever comes in."""
        x = x.float()
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight.float()


# ---------------------------------------------------------------------------
# the decode state

class DecodeState:
    """The decode state of a hybrid decoder, one flat buffer a kind: conv
    states ``conv`` [layers, B, channels, taps] (float32), SSM states
    ``ssm`` [layers, B, heads, head_dim, state] (float32, None for a model
    without SSM layers) and KV slots ``kv`` [layers, 2, B, kv_heads, slots,
    head_dim] (``dtype``), with the rows' key mask and next position. The
    prefix is right-aligned to ``prefix_slots``; decode step ``i`` writes
    slot ``prefix_slots + i``."""

    def __init__(self, batch: int, prefix_slots: int, new_slots: int, dtype: torch.dtype,
                 device, conv: Tuple[int, int, int], kv: Tuple[int, int, int],
                 ssm: Optional[Tuple[int, int, int, int]] = None):
        self.prefix_slots = prefix_slots
        self.slots = prefix_slots + new_slots
        n_conv, channels, taps = conv
        n_attn, kv_heads, head_dim = kv
        self.conv = torch.zeros((n_conv, batch, channels, taps), dtype=torch.float32,
                                device=device)
        self.ssm = None if ssm is None else torch.zeros((ssm[0], batch, *ssm[1:]),
                                                        dtype=torch.float32, device=device)
        self.kv = torch.zeros((n_attn, 2, batch, kv_heads, self.slots, head_dim), dtype=dtype,
                              device=device)
        self.mask = torch.zeros((batch, self.slots), dtype=torch.bool, device=device)
        self.position = torch.zeros(batch, dtype=torch.long, device=device)

    def zero_(self) -> None:
        for t in (self.conv, self.ssm, self.kv, self.mask, self.position):
            if t is not None:
                t.zero_()


@dataclass
class _Ctx:
    """What a layer needs beside its input: the mode, the cache and where it
    writes, the key mask, RoPE's cos / sin, the rows that are real."""
    cache: Optional[DecodeState]
    step: Optional[int]                 # decode step index; None in a prefill
    keep: Optional[torch.Tensor]        # bool [B, L]: real positions (prefill)
    cos: Optional[torch.Tensor]         # None: no positional encoding
    sin: Optional[torch.Tensor]
    conv_slot: List[int]
    attn_slot: List[int]


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """float32 cos, sin [..., head_dim] of integer ``positions`` (rotate-half
    layout: the frequencies twice)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=positions.device,
                                        dtype=torch.float32) / head_dim))
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], -1)
    return ang.cos(), ang.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x float32 [B, L, heads, d]; cos / sin [B, L, d]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos[:, :, None] + rot * sin[:, :, None]


# ---------------------------------------------------------------------------
# mixers

def causal_conv(u: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                keep: torch.Tensor, state: Optional[torch.Tensor]) -> torch.Tensor:
    """The causal depthwise conv of a left-padded prefill: ``u`` float32 [B,
    L, C] (zeroed at pad positions, so a row sees zeros before its first
    real one), ``w`` [C, taps], ``bias`` [C] or None. ``state`` [B, C, taps]
    takes the last ``taps`` inputs. Returns float32 [B, L, C]."""
    u = u * keep[..., None]
    L, taps = u.shape[1], w.shape[1]
    pad = F.pad(u.transpose(1, 2), (taps - 1, 0))           # [B, C, taps - 1 + L]
    y = pad[..., 0:L] * w[:, 0:1]
    for j in range(1, taps):
        y = y + pad[..., j:j + L] * w[:, j:j + 1]
    if bias is not None:
        y = y + bias[:, None]
    if state is not None:
        state.copy_(pad[..., -taps:])
    return y.transpose(1, 2)


def causal_conv_step(state: torch.Tensor, u: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    """One decode position: ``u`` [B, C] shifted into ``state`` [B, C, taps]
    in place; returns the conv's float32 [B, C]."""
    state.copy_(torch.cat([state[..., 1:], u[:, :, None]], -1))
    y = state[..., 0] * w[:, 0]
    for j in range(1, w.shape[1]):
        y = y + state[..., j] * w[:, j]
    return y if bias is None else y + bias


class ShortConv(nn.Module):
    def __init__(self, cfg: LFM2Config, dtype: torch.dtype):
        super().__init__()
        D = cfg.hidden_size
        self.cfg = cfg
        self.in_proj = Dense(D, 3 * D, dtype, bias=cfg.conv_bias)
        self.conv = nn.Conv1d(D, D, cfg.conv_L_cache, groups=D, bias=False)
        self.out_proj = Dense(D, D, dtype, bias=cfg.conv_bias)

    def forward(self, x: torch.Tensor, ctx: _Ctx, slot: int) -> torch.Tensor:
        b, c, xt = self.in_proj(x).float().chunk(3, -1)
        bx = b * xt                                         # [B, L, D]
        w = self.conv.weight.float()[:, 0]                  # [D, taps]
        if ctx.step is None:
            y = causal_conv(bx, w, None, ctx.keep,
                            None if ctx.cache is None else ctx.cache.conv[slot])
        else:
            y = causal_conv_step(ctx.cache.conv[slot], bx[:, 0], w, None)[:, None]
        return self.out_proj(c * y)


class GQAttention(nn.Module):
    def __init__(self, cfg: LFM2Config, dtype: torch.dtype):
        super().__init__()
        D, H, KV, d = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        self.cfg, self.dtype = cfg, dtype
        self.q_proj = Dense(D, H * d, dtype, bias=False)
        self.k_proj = Dense(D, KV * d, dtype, bias=False)
        self.v_proj = Dense(D, KV * d, dtype, bias=False)
        self.out_proj = Dense(H * d, D, dtype, bias=False)
        self.q_layernorm = RMSNorm(d, cfg.norm_eps)
        self.k_layernorm = RMSNorm(d, cfg.norm_eps)

    def forward(self, x: torch.Tensor, ctx: _Ctx, slot: int) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        H, KV, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = apply_rope(self.q_layernorm(self.q_proj(x).view(B, L, H, d)), ctx.cos, ctx.sin)
        k = apply_rope(self.k_layernorm(self.k_proj(x).view(B, L, KV, d)), ctx.cos, ctx.sin)
        v = self.v_proj(x).view(B, L, KV, d)
        return self.out_proj(attend(q, k, v, ctx, slot, self.dtype))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ctx: _Ctx, slot: int,
           dtype: torch.dtype) -> torch.Tensor:
    """Causal GQA over the prefill's keys or the cache's: ``q`` float32 [B, L,
    H, d], ``k`` / ``v`` [B, L, KV, d], rounded to ``dtype`` as the KV cache
    holds them (a prefill writes them at the prefix slots, a decode step at
    its slot); scores and softmax float32 at ``1/sqrt(d)``, pad keys masked.
    Returns float32 [B, L, H * d]."""
    B, L, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    k, v = k.to(dtype).transpose(1, 2), v.to(dtype).transpose(1, 2)
    if ctx.step is None:
        if ctx.cache is not None:
            P = ctx.cache.prefix_slots
            ctx.cache.kv[slot, 0, :, :, P - L:P] = k
            ctx.cache.kv[slot, 1, :, :, P - L:P] = v
        causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        keep = causal[None] & ctx.keep[:, None, :]          # [B, L, L]
    else:
        at = ctx.cache.prefix_slots + ctx.step
        ctx.cache.kv[slot, 0, :, :, at] = k[:, :, 0]
        ctx.cache.kv[slot, 1, :, :, at] = v[:, :, 0]
        k, v = ctx.cache.kv[slot, 0], ctx.cache.kv[slot, 1]
        keep = ctx.cache.mask[:, None, :]                   # [B, 1, S]
    # query heads grouped by their KV head: [B, KV, G * L, d]
    qg = q.view(B, L, KV, G, d).permute(0, 2, 3, 1, 4).reshape(B, KV, G * L, d)
    scores = torch.matmul(qg, k.float().transpose(-1, -2)) * (d ** -0.5)
    scores = scores.view(B, KV, G, L, -1)
    scores = torch.where(keep[:, None, None], scores, scores.new_full((), NEG_INF))
    att = F.softmax(scores, -1).view(B, KV, G * L, -1)
    out = torch.matmul(att, v.float()).view(B, KV, G, L, d)
    return out.permute(0, 3, 1, 2, 4).reshape(B, L, H * d)


# ---------------------------------------------------------------------------
# feed-forwards

class DenseFF(nn.Module):
    def __init__(self, cfg: LFM2Config, dtype: torch.dtype):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.dtype = dtype
        self.w1 = Dense(D, I, dtype, bias=False)
        self.w3 = Dense(D, I, dtype, bias=False)
        self.w2 = Dense(I, D, dtype, bias=False)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        h = F.silu(self.w1(x).float()) * self.w3(x).float()
        return self.w2(h.to(self.dtype))


class Experts(nn.Module):
    """The experts a layer holds, stacked: ``w1``, ``w3`` [E, M, D], ``w2``
    [E, D, M]."""

    def __init__(self, cfg: LFM2Config):
        super().__init__()
        E, M, D = cfg.num_experts, cfg.moe_intermediate_size, cfg.hidden_size
        self.w1 = nn.Parameter(torch.empty(E, M, D))
        self.w3 = nn.Parameter(torch.empty(E, M, D))
        self.w2 = nn.Parameter(torch.empty(E, D, M))


def sigmoid_topk_route(x: torch.Tensor, gate: torch.Tensor, bias: Optional[torch.Tensor],
                       k: int, normalise: bool, eps: float, scale: float):
    """float32 routing of rows ``x`` [N, D] by sigmoid scores ``s =
    sigmoid(x gate^T)``: the experts ``top_k(s + bias)`` (``bias`` None:
    ``s``), each weighted by its own score, over the chosen scores' sum plus
    ``eps`` where ``normalise``, times ``scale``. Returns (int32 experts [N,
    k], float32 weights [N, k])."""
    s = torch.sigmoid(F.linear(x.float(), gate.float()))
    pick = s + bias.float() if bias is not None else s
    idx = torch.topk(pick, k, dim=-1).indices
    w = s.gather(-1, idx)
    if normalise:
        w = w / (w.sum(-1, keepdim=True) + eps)
    return idx.to(torch.int32), w * scale


class MoEFF(nn.Module):
    """The expert feed-forward. Where ``routes`` is a list, each eager call
    appends the int32 experts [N, k] it hands the expert layer (-1 for a pad
    row): a check of the routing reads them (a captured step appends only
    while it is captured)."""

    def __init__(self, cfg: LFM2Config, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.gate = nn.Linear(cfg.hidden_size, cfg.num_experts, bias=False)
        self.expert_bias = nn.Parameter(torch.zeros(cfg.num_experts))
        self.experts = Experts(cfg)
        self.routes: Optional[List[torch.Tensor]] = None

    def route(self, x: torch.Tensor):
        """float32 routing of rows ``x`` [N, D]: (int32 experts [N, k], float32
        weights [N, k])."""
        cfg = self.cfg
        return sigmoid_topk_route(x, self.gate.weight,
                                  self.expert_bias if cfg.use_expert_bias else None,
                                  cfg.num_experts_per_tok, cfg.norm_topk_prob, 1e-6,
                                  cfg.routed_scaling_factor)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        B, L, D = x.shape
        rows = x.reshape(B * L, D).to(self.dtype)
        idx, w = self.route(rows)
        if keep is not None:
            idx = torch.where(keep.reshape(B * L, 1), idx, -1)
        if self.routes is not None:
            self.routes.append(idx)
        ex = self.experts
        out = moe_ops.moe_experts(rows, idx, w, ex.w1.to(self.dtype), ex.w3.to(self.dtype),
                                  ex.w2.to(self.dtype), moe_ops.device_counters(x.device))
        return out.view(B, L, D)


class Lfm2Layer(nn.Module):
    def __init__(self, cfg: LFM2Config, i: int, dtype: torch.dtype):
        super().__init__()
        self.kind = cfg.layer_types[i]
        self.operator_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.ffn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        if self.kind == "conv":
            self.conv = ShortConv(cfg, dtype)
        else:
            self.self_attn = GQAttention(cfg, dtype)
        self.feed_forward = DenseFF(cfg, dtype) if i < cfg.num_dense_layers else MoEFF(cfg, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, ctx: _Ctx, i: int) -> torch.Tensor:
        h = self.operator_norm(x).to(self.dtype)
        if self.kind == "conv":
            h = self.conv(h, ctx, ctx.conv_slot[i])
        else:
            h = self.self_attn(h, ctx, ctx.attn_slot[i])
        x = x + h.float()
        return x + self.feed_forward(self.ffn_norm(x).to(self.dtype), ctx.keep).float()


class Lfm2ForCausalLM(nn.Module):
    """Parameters in ``param_dtype`` (the router's in float32), products in
    ``dtype``. Built where torch's default device says; ``Blip2LFM2`` builds
    it on ``meta`` and places it."""

    span = "lfm2"

    def __init__(self, cfg: LFM2Config, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        if not cfg.tie_embedding:
            raise ValueError("LFM2Config.tie_embedding=False is not supported")
        self.cfg, self.dtype = cfg, dtype
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, dtype)
        self.layers = nn.ModuleList(Lfm2Layer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.embedding_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.to(param_dtype)
        for layer in self.layers:
            if isinstance(layer.feed_forward, MoEFF):
                layer.feed_forward.gate.float()
                layer.feed_forward.expert_bias.data = layer.feed_forward.expert_bias.data.float()
        conv = attn = 0
        self._conv_slot, self._attn_slot = [], []
        for t in cfg.layer_types:
            self._conv_slot.append(conv)
            self._attn_slot.append(attn)
            conv, attn = conv + (t == "conv"), attn + (t != "conv")

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(ids)

    def init_cache(self, batch: int, prefix_slots: int, new_slots: int, device=None
                   ) -> DecodeState:
        """Conv states of the conv layers and KV slots of the attention
        layers; no SSM states."""
        cfg = self.cfg
        n_conv = sum(t == "conv" for t in cfg.layer_types)
        return DecodeState(batch, prefix_slots, new_slots, self.dtype,
                           device or self.embed_tokens.weight.device,
                           conv=(n_conv, cfg.hidden_size, cfg.conv_L_cache),
                           kv=(len(cfg.layer_types) - n_conv, cfg.num_key_value_heads,
                               cfg.head_dim))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 logits of the last hidden states ``x``."""
        h = self.embedding_norm(x).to(self.dtype)
        return F.linear(h, self.embed_tokens.weight.to(self.dtype)).float()

    def _run(self, x: torch.Tensor, ctx: _Ctx) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, ctx, i)
        return x

    def hidden_states(self, inputs_embeds: torch.Tensor, mask: torch.Tensor,
                      cache: Optional[DecodeState] = None) -> torch.Tensor:
        """float32 [B, L, D] after the last layer (before ``embedding_norm``)
        of a left-padded batch; fills ``cache`` (its prefix right-aligned, the
        rows' key mask and next positions) where one is given."""
        cfg = self.cfg
        keep = mask.bool()
        positions = (torch.cumsum(keep.long(), 1) - 1).clamp(min=0)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        if cache is not None:
            P, L = cache.prefix_slots, mask.shape[1]
            cache.zero_()
            cache.mask[:, P - L:P] = keep
            cache.position.copy_(keep.sum(1))
        ctx = _Ctx(cache, None, keep, cos, sin, self._conv_slot, self._attn_slot)
        return self._run(inputs_embeds.float(), ctx)

    def prefill(self, inputs_embeds: torch.Tensor, mask: torch.Tensor,
                cache: DecodeState) -> torch.Tensor:
        """float32 logits [B, vocab] at the last position of a left-padded
        batch; the cache takes its state."""
        return self._logits(self.hidden_states(inputs_embeds, mask, cache)[:, -1])

    def decode_step(self, token_ids: torch.Tensor, cache: DecodeState, step: int
                    ) -> torch.Tensor:
        """One token a row (``token_ids`` [B, 1]) at slot ``prefix_slots +
        step``; float32 logits [B, vocab]. No host read."""
        cfg = self.cfg
        cache.mask[:, cache.prefix_slots + step] = True
        cos, sin = rope_cos_sin(cache.position[:, None], cfg.head_dim, cfg.rope_theta)
        ctx = _Ctx(cache, step, None, cos, sin, self._conv_slot, self._attn_slot)
        x = self._run(self.embed(token_ids).float(), ctx)
        cache.position.add_(1)
        return self._logits(x[:, -1])
