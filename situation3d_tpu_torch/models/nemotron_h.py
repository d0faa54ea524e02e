"""Nemotron-H, a decoder-only causal LM of three kinds of layer (NVIDIA's
``nemotron_h``, as Hugging Face's ``NemotronH`` modelling code writes it).
Sized for Nemotron-3-Nano-30B-A3B.

Each layer is ``x = x + mixer(rms(x))``, one mixer a layer, the kind named
by ``hybrid_override_pattern``; a final RMS norm (``norm_f``) and an untied
head follow. RMS norms are ``x * rsqrt(mean x^2 + eps) * w``.

- ``M``, the Mamba-2 mixer: ``z, xBC, dt = split(in_proj x)``; ``xBC =
  silu(causal_depthwise_conv(xBC) + conv_bias)``, then ``x, B, C`` (heads of
  ``mamba_head_dim``, ``n_groups`` groups of ``ssm_state_size``); ``dt =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the selective recurrence
  ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T``, ``y_t = S_t C_t + D x_t``
  (``ops/cuda/ssm_scan.py``); ``y = rms_group(y * silu(z)) * w`` over
  ``n_groups`` groups of channels; ``out_proj``. In decode its state is the
  conv's last ``conv_kernel`` inputs and ``S``.
- ``*``, attention: GQA with no positional encoding and no norms of q or k,
  a causal softmax at ``1/sqrt(head_dim)``, ``o_proj``. In decode its state
  is a KV cache.
- ``E``, the expert layer: ``s = sigmoid(gate x)``, the experts
  ``top_k(s + e_score_correction_bias)``, each weighted by its own ``s``
  over the chosen ones' sum (+1e-20), times ``routed_scaling_factor``
  (``lfm2.sigmoid_topk_route``); the experts ``down(relu(up x)^2)`` through
  ``ops/cuda/moe_experts.py``'s non-gated form, plus a shared expert of the
  same form on :class:`Dense`.

Departures from the modelling code, each for agreement with a float32
reading, as ``models/lfm2.py`` has them: parameters are held in
``param_dtype`` and products run in ``dtype``, but the residual stream, the
norms, the conv, the recurrence and its state, the gated norm and the
attention scores and softmax are float32; the router and its bias are held
and run in float32; the KV cache holds ``dtype`` values.

Batches are left-padded as LFM2's are (``lfm2.DecodeState``): at a pad
position the conv's input is zero and ``dt`` is 0, so a row's conv and SSM
states are what they would be alone; pad keys are masked; pad tokens are
routed to no expert.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from situation3d_tpu_torch.models.layers import Dense, Embed
from situation3d_tpu_torch.models.lfm2 import (DecodeState, RMSNorm, _Ctx, attend,
                                               causal_conv, causal_conv_step,
                                               sigmoid_topk_route)
from situation3d_tpu_torch.ops.cuda import moe_experts as moe_ops
from situation3d_tpu_torch.ops.cuda import ssm_scan as ssm_ops

NANO_30B_PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
ROUTER_EPS = 1e-20

# published keys that describe nothing this port computes: initialisation,
# positions it never reaches, or kernels of the modelling code
_UNREAD = ("chunk_size", "expand", "intermediate_size", "max_position_embeddings",
           "model_type", "norm_eps", "num_logits_to_keep", "partial_rotary_factor",
           "rescale_prenorm_residual", "residual_in_fp32", "rope_theta", "time_step_floor",
           "time_step_max", "time_step_min", "use_mamba_kernels")
# published keys whose value this port requires
_REQUIRED = {"attention_bias": False, "mamba_hidden_act": "silu", "mamba_proj_bias": False,
             "mlp_bias": False, "mlp_hidden_act": "relu2", "n_group": 1, "n_shared_experts": 1,
             "sliding_window": None, "tie_word_embeddings": False, "topk_group": 1,
             "use_bias": False}


@dataclass
class NemotronHConfig:
    """Nemotron-H; the defaults are Nemotron-3-Nano-30B-A3B's published
    ``config.json``."""
    vocab_size: int = 131072
    hidden_size: int = 2688
    num_hidden_layers: int = 52
    hybrid_override_pattern: str = NANO_30B_PATTERN
    layer_norm_epsilon: float = 1e-5
    num_attention_heads: int = 32
    num_key_value_heads: int = 2
    head_dim: int = 128
    mamba_num_heads: int = 64
    mamba_head_dim: int = 64
    n_groups: int = 8
    ssm_state_size: int = 128
    conv_kernel: int = 4
    use_conv_bias: bool = True
    chunk_size: int = 128
    n_routed_experts: int = 128
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1856
    moe_shared_expert_intermediate_size: int = 3712
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.5
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0

    @property
    def d_inner(self) -> int:
        return self.mamba_num_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.ssm_state_size

    @classmethod
    def from_published(cls, c: dict, **ids) -> "NemotronHConfig":
        """The config of a published ``config.json``'s keys ``c`` (and the
        special ``ids``); raises on a value this port does not compute."""
        for k, v in _REQUIRED.items():
            if k in c and c[k] != v:
                raise ValueError(f"nemotron_h: {k}={c[k]!r} is not supported (only {v!r})")
        if c.get("num_hidden_layers", len(c["hybrid_override_pattern"])) != len(
                c["hybrid_override_pattern"]) or set(c["hybrid_override_pattern"]) - set("ME*"):
            raise ValueError(f"nemotron_h: pattern {c['hybrid_override_pattern']!r}")
        keep = {k: v for k, v in c.items() if k not in _UNREAD and k not in _REQUIRED}
        return cls(**keep, **ids)


def step_sizes(dt: torch.Tensor, dt_bias: torch.Tensor, keep: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """float32 ``softplus(dt + dt_bias)``, 0 where ``keep`` is false."""
    delta = F.softplus(dt + dt_bias.float())
    return delta if keep is None else delta * keep[..., None]


class Mamba2Mixer(nn.Module):
    def __init__(self, cfg: NemotronHConfig, dtype: torch.dtype):
        super().__init__()
        H = cfg.mamba_num_heads
        self.cfg, self.dtype = cfg, dtype
        self.in_proj = Dense(cfg.hidden_size, cfg.d_inner + cfg.conv_dim + H, dtype, bias=False)
        self.conv1d = nn.Conv1d(cfg.conv_dim, cfg.conv_dim, cfg.conv_kernel, groups=cfg.conv_dim,
                                bias=cfg.use_conv_bias)
        self.dt_bias = nn.Parameter(torch.ones(H))
        self.A_log = nn.Parameter(torch.zeros(H))
        self.D = nn.Parameter(torch.ones(H))
        self.norm = RMSNorm(cfg.d_inner, cfg.layer_norm_epsilon)
        self.out_proj = Dense(cfg.d_inner, cfg.hidden_size, dtype, bias=False)

    def gated_norm(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """float32 ``rms(y * silu(z))`` over each of ``n_groups`` groups of
        channels, times the norm's weight."""
        g = (y * F.silu(z)).unflatten(-1, (self.cfg.n_groups, -1))
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + self.norm.eps)
        return g.flatten(-2) * self.norm.weight.float()

    def forward(self, x: torch.Tensor, ctx: _Ctx, slot: int) -> torch.Tensor:
        cfg = self.cfg
        z, xbc, dt = self.in_proj(x).float().split([cfg.d_inner, cfg.conv_dim,
                                                    cfg.mamba_num_heads], -1)
        w = self.conv1d.weight.float()[:, 0]
        bias = None if self.conv1d.bias is None else self.conv1d.bias.float()
        A, D = -torch.exp(self.A_log.float()), self.D.float()
        counters = ssm_ops.device_counters(x.device)
        if ctx.step is None:
            conv_state = None if ctx.cache is None else ctx.cache.conv[slot]
            xbc = F.silu(causal_conv(xbc, w, bias, ctx.keep, conv_state))
            state = (ctx.cache.ssm[slot] if ctx.cache is not None else
                     xbc.new_empty(x.shape[0], cfg.mamba_num_heads, cfg.mamba_head_dim,
                                   cfg.ssm_state_size))
            y = ssm_ops.ssm_scan(xbc.contiguous(), step_sizes(dt, self.dt_bias, ctx.keep),
                                 A, D, cfg.n_groups, cfg.ssm_state_size, state, ctx.keep,
                                 cfg.chunk_size, counters)
        else:
            xbc = F.silu(causal_conv_step(ctx.cache.conv[slot], xbc[:, 0], w, bias))
            y = ssm_ops.ssm_update(xbc, step_sizes(dt[:, 0], self.dt_bias, None), A, D,
                                   cfg.n_groups, cfg.ssm_state_size, ctx.cache.ssm[slot],
                                   counters)[:, None]
        return self.out_proj(self.gated_norm(y, z).to(self.dtype))


class NoPEAttention(nn.Module):
    """GQA with no positional encoding."""

    def __init__(self, cfg: NemotronHConfig, dtype: torch.dtype):
        super().__init__()
        D, H, KV, d = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        self.cfg, self.dtype = cfg, dtype
        self.q_proj = Dense(D, H * d, dtype, bias=False)
        self.k_proj = Dense(D, KV * d, dtype, bias=False)
        self.v_proj = Dense(D, KV * d, dtype, bias=False)
        self.o_proj = Dense(H * d, D, dtype, bias=False)

    def forward(self, x: torch.Tensor, ctx: _Ctx, slot: int) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        q = self.q_proj(x).float().view(B, L, cfg.num_attention_heads, cfg.head_dim)
        k = self.k_proj(x).view(B, L, cfg.num_key_value_heads, cfg.head_dim)
        v = self.v_proj(x).view(B, L, cfg.num_key_value_heads, cfg.head_dim)
        return self.o_proj(attend(q, k, v, ctx, slot, self.dtype))


class Relu2MLP(nn.Module):
    """``down(relu(up x)^2)``, the shared expert."""

    def __init__(self, hidden: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.up_proj = Dense(hidden, width, dtype, bias=False)
        self.down_proj = Dense(width, hidden, dtype, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.relu(self.up_proj(x).float()).square().to(self.dtype))


class RoutedExperts(nn.Module):
    """A layer's experts, stacked: ``up`` [E, M, D], ``down`` [E, D, M]."""

    def __init__(self, cfg: NemotronHConfig):
        super().__init__()
        E, M, D = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.hidden_size
        self.up = nn.Parameter(torch.empty(E, M, D))
        self.down = nn.Parameter(torch.empty(E, D, M))


class NemotronMoE(nn.Module):
    """The expert layer. Where ``routes`` is a list, each eager call appends
    the int32 experts [N, k] it hands the expert kernel (-1 for a pad row),
    as ``lfm2.MoEFF`` does."""

    def __init__(self, cfg: NemotronHConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.gate = nn.Linear(cfg.hidden_size, cfg.n_routed_experts, bias=False)
        self.e_score_correction_bias = nn.Parameter(torch.zeros(cfg.n_routed_experts))
        self.experts = RoutedExperts(cfg)
        self.shared_experts = Relu2MLP(cfg.hidden_size, cfg.moe_shared_expert_intermediate_size,
                                       dtype)
        self.routes: Optional[List[torch.Tensor]] = None

    def route(self, x: torch.Tensor):
        cfg = self.cfg
        return sigmoid_topk_route(x, self.gate.weight, self.e_score_correction_bias,
                                  cfg.num_experts_per_tok, cfg.norm_topk_prob, ROUTER_EPS,
                                  cfg.routed_scaling_factor)

    def forward(self, x: torch.Tensor, ctx: _Ctx, slot: int) -> torch.Tensor:
        B, L, D = x.shape
        rows = x.reshape(B * L, D)
        idx, w = self.route(rows)
        if ctx.keep is not None:
            idx = torch.where(ctx.keep.reshape(B * L, 1), idx, -1)
        if self.routes is not None:
            self.routes.append(idx)
        ex = self.experts
        out = moe_ops.moe_experts(rows, idx, w, ex.up.to(self.dtype), None,
                                  ex.down.to(self.dtype), moe_ops.device_counters(x.device))
        return out.view(B, L, D) + self.shared_experts(x).float()


_MIXERS = {"M": Mamba2Mixer, "*": NoPEAttention, "E": NemotronMoE}


class NemotronHBlock(nn.Module):
    def __init__(self, cfg: NemotronHConfig, i: int, dtype: torch.dtype):
        super().__init__()
        self.kind = cfg.hybrid_override_pattern[i]
        self.dtype = dtype
        self.norm = RMSNorm(cfg.hidden_size, cfg.layer_norm_epsilon)
        self.mixer = _MIXERS[self.kind](cfg, dtype)

    def forward(self, x: torch.Tensor, ctx: _Ctx, slot: int) -> torch.Tensor:
        return x + self.mixer(self.norm(x).to(self.dtype), ctx, slot).float()


class NemotronHForCausalLM(nn.Module):
    """Parameters in ``param_dtype`` (the router, its bias, the conv and the
    SSM's scalars in float32), products in ``dtype``. The LM interface
    ``models/blip2_lfm2.py`` decodes through: ``embed``, ``init_cache``,
    ``prefill``, ``decode_step``."""

    span = "nemotron_h"

    def __init__(self, cfg: NemotronHConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embeddings = Embed(cfg.vocab_size, cfg.hidden_size, dtype)
        self.layers = nn.ModuleList(NemotronHBlock(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm_f = RMSNorm(cfg.hidden_size, cfg.layer_norm_epsilon)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, dtype, bias=False)
        self.to(param_dtype)
        for layer in self.layers:
            m = layer.mixer
            if isinstance(m, NemotronMoE):
                m.gate.float()
                m.e_score_correction_bias.data = m.e_score_correction_bias.data.float()
            elif isinstance(m, Mamba2Mixer):
                m.conv1d.float()
                for p in (m.dt_bias, m.A_log, m.D):
                    p.data = p.data.float()
        # each layer's index into its kind's state buffer
        count = {"M": 0, "*": 0, "E": 0}
        self._slot = []
        for kind in cfg.hybrid_override_pattern:
            self._slot.append(count[kind])
            count[kind] += 1
        self._count = count

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embeddings(ids)

    def init_cache(self, batch: int, prefix_slots: int, new_slots: int, device=None
                   ) -> DecodeState:
        cfg = self.cfg
        return DecodeState(batch, prefix_slots, new_slots, self.dtype,
                           device or self.embeddings.weight.device,
                           conv=(self._count["M"], cfg.conv_dim, cfg.conv_kernel),
                           kv=(self._count["*"], cfg.num_key_value_heads, cfg.head_dim),
                           ssm=(self._count["M"], cfg.mamba_num_heads, cfg.mamba_head_dim,
                                cfg.ssm_state_size))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.norm_f(x).to(self.dtype)).float()

    def _run(self, x: torch.Tensor, ctx: _Ctx) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, ctx, self._slot[i])
        return x

    def hidden_states(self, inputs_embeds: torch.Tensor, mask: torch.Tensor,
                      cache: Optional[DecodeState] = None) -> torch.Tensor:
        """float32 [B, L, D] after the last layer (before ``norm_f``) of a
        left-padded batch; fills ``cache`` where one is given."""
        keep = mask.bool()
        if cache is not None:
            P, L = cache.prefix_slots, mask.shape[1]
            cache.zero_()
            cache.mask[:, P - L:P] = keep
            cache.position.copy_(keep.sum(1))
        ctx = _Ctx(cache, None, keep, None, None, [], [])
        return self._run(inputs_embeds.float(), ctx)

    def prefill(self, inputs_embeds: torch.Tensor, mask: torch.Tensor, cache: DecodeState
                ) -> torch.Tensor:
        """float32 logits [B, vocab] at the last position of a left-padded
        batch; the cache takes its state."""
        return self._logits(self.hidden_states(inputs_embeds, mask, cache)[:, -1])

    def decode_step(self, token_ids: torch.Tensor, cache: DecodeState, step: int
                    ) -> torch.Tensor:
        """One token a row (``token_ids`` [B, 1]) at slot ``prefix_slots +
        step``; float32 logits [B, vocab]. No host read."""
        cache.mask[:, cache.prefix_slots + step] = True
        ctx = _Ctx(cache, step, None, None, None, [], [])
        x = self._run(self.embed(token_ids).float(), ctx)
        cache.position.add_(1)
        return self._logits(x[:, -1])


def parameter_count(cfg: NemotronHConfig) -> int:
    """The LM's parameters, reckoned from the shapes."""
    D, V = cfg.hidden_size, cfg.vocab_size
    H = cfg.mamba_num_heads
    mamba = (D * (cfg.d_inner + cfg.conv_dim + H) + cfg.conv_dim * (cfg.conv_kernel + 1)
             + 3 * H + cfg.d_inner + cfg.d_inner * D)
    attn = D * cfg.head_dim * (2 * cfg.num_attention_heads + 2 * cfg.num_key_value_heads)
    moe = (cfg.n_routed_experts * (D + 1 + 2 * D * cfg.moe_intermediate_size)
           + 2 * D * cfg.moe_shared_expert_intermediate_size)
    per = {"M": mamba, "*": attn, "E": moe}
    return (2 * V * D + D + sum(per[k] + D for k in cfg.hybrid_override_pattern))

