"""Plain PyTorch reference of the 3D-LLM with an LFM2-MoE language model
(``lfm2_moe``, as Hugging Face's ``Lfm2Moe`` modelling code describes it):

- the scene's 32 queries: ``reference/blip2.py``'s Q-Former (features plus
  0.01 x the voxel encoding), then ``lfm2_proj`` to the LM's width;
- each question alone, unpadded, as one causal sequence [queries ; prompt
  tokens ; served tokens], teacher-forced in one full forward: no cache, no
  batching, no kernels;
- a layer ``h = x + mixer(rms(x))``, ``y = h + ff(rms(h))``, RMS norms
  ``x * rsqrt(mean x^2 + eps) * w``; the ``conv`` mixer ``out_proj(C *
  causal_depthwise_conv(B * x~))`` with ``B, C, x~ = chunk3(in_proj(x))``;
  the ``full_attention`` mixer GQA with RMS norms over each head of q and k
  before rotate-half RoPE (positions 0, 1, ... of the sequence), causal
  softmax at ``1/sqrt(head_dim)``; the first ``num_dense_layers`` a dense
  SwiGLU, the rest ``sum_k w_k * w2_e(silu(w1_e x) * w3_e x)`` over the
  experts ``top_k(sigmoid(gate x) + expert_bias)``, ``w_k`` each chosen
  expert's sigmoid over their sum plus 1e-6, times
  ``routed_scaling_factor``; ``embedding_norm`` and the head tied to the
  token embedding.

Departures from the modelling code: float32 throughout, TF32 off (the
model is published in bfloat16); the weights are the benchmark's random draws. Products
run in ``precision`` (``reference/precision.py``), the gate's too. The model
runs a layer at a time over all the questions given: each layer's weights
are made, used and dropped, so the whole never needs to be held. Imports
nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmarks.reference import blip2
from benchmarks.reference.precision import Exact, exact_float32

Weight = Callable[[str], torch.Tensor]     # name -> float32 tensor on the device

# the T5 widths reference/blip2.py's spec reads; only its Q-Former names are kept
_NO_T5 = {"t5.d_model": 8, "t5.num_heads": 1, "t5.d_kv": 8, "t5.d_ff": 8, "t5.vocab_size": 8,
          "t5.num_layers": 0, "t5.num_decoder_layers": 0, "t5.relative_attention_num_buckets": 1}


# the keys of LFM2's published config.json, which a configuration file holds
# at its top level
PUBLISHED = ("conv_L_cache", "conv_bias", "hidden_size", "intermediate_size", "layer_types",
             "max_position_embeddings", "model_type", "moe_intermediate_size", "norm_eps",
             "norm_topk_prob", "num_attention_heads", "num_dense_layers", "num_experts",
             "num_experts_per_tok", "num_hidden_layers", "num_key_value_heads",
             "rope_parameters", "routed_scaling_factor", "use_expert_bias", "vocab_size")


def settings(config: dict) -> dict:
    """A configuration's settings with its published keys folded in as
    ``lfm2.<key>``; a key the settings name themselves wins."""
    return {**{f"lfm2.{k}": config[k] for k in PUBLISHED if k in config}, **config["settings"]}


def lm(s: dict) -> dict:
    """The language model's settings, ``lfm2.`` stripped."""
    return {k[5:]: v for k, v in s.items() if k.startswith("lfm2.")}


def rope_theta(c: dict) -> float:
    return float(c["rope_parameters"]["rope_theta"])


def head_dim(c: dict) -> int:
    return c["hidden_size"] // c["num_attention_heads"]


def param_spec(s: dict) -> Dict[str, Tuple[int, ...]]:
    c = lm(s)
    D, V, I, M, E = (c["hidden_size"], c["vocab_size"], c["intermediate_size"],
                     c["moe_intermediate_size"], c["num_experts"])
    H, KV, d = c["num_attention_heads"], c["num_key_value_heads"], head_dim(c)
    spec = {n: v for n, v in blip2.param_spec({**s, **_NO_T5}).items() if n.startswith("qformer.")}
    spec["lfm2_proj.weight"], spec["lfm2_proj.bias"] = (D, s["qformer.hidden_size"]), (D,)
    spec["lfm2.embed_tokens.weight"] = (V, D)
    spec["lfm2.embedding_norm.weight"] = (D,)
    for i, kind in enumerate(c["layer_types"]):
        p = f"lfm2.layers.{i}"
        spec[f"{p}.operator_norm.weight"] = spec[f"{p}.ffn_norm.weight"] = (D,)
        if kind == "conv":
            spec[f"{p}.conv.in_proj.weight"] = (3 * D, D)
            spec[f"{p}.conv.conv.weight"] = (D, 1, c["conv_L_cache"])
            spec[f"{p}.conv.out_proj.weight"] = (D, D)
        else:
            a = f"{p}.self_attn"
            spec[f"{a}.q_proj.weight"], spec[f"{a}.out_proj.weight"] = (H * d, D), (D, H * d)
            spec[f"{a}.k_proj.weight"] = spec[f"{a}.v_proj.weight"] = (KV * d, D)
            spec[f"{a}.q_layernorm.weight"] = spec[f"{a}.k_layernorm.weight"] = (d,)
        f = f"{p}.feed_forward"
        if i < c["num_dense_layers"]:
            spec[f"{f}.w1.weight"] = spec[f"{f}.w3.weight"] = (I, D)
            spec[f"{f}.w2.weight"] = (D, I)
        else:
            spec[f"{f}.gate.weight"], spec[f"{f}.expert_bias"] = (E, D), (E,)
            spec[f"{f}.experts.w1"] = spec[f"{f}.experts.w3"] = (E, M, D)
            spec[f"{f}.experts.w2"] = (E, D, M)
    return spec


class LFM2Reference:
    def __init__(self, s: dict, weight: Weight, precision: Exact = None):
        exact_float32()                 # TF32 off: a float32 product is a float32 product
        self.s, self.c, self.p = s, lm(s), precision or Exact()
        self._make, self._held = weight, {}
        self.routes: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None

    def weight(self, name: str) -> torch.Tensor:
        """``name``'s float32 tensor, made once while its layer runs."""
        if name not in self._held:
            self._held[name] = self._make(name)
        return self._held[name]

    def rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.c["norm_eps"]) * w

    def lin(self, x, w):
        return self.p.linear(x, w)

    # -- the scene --------------------------------------------------------------
    def queries(self, pc_feat, pc, pc_mask) -> torch.Tensor:
        """[B, 32, hidden] for a batch of scenes (each row alone)."""
        names = [n for n in param_spec(self.s) if n.startswith(("qformer.", "lfm2_proj."))]
        w = {n.replace("lfm2_proj", "t5_proj"): self.weight(n) for n in names}
        return blip2.Blip2Reference(self.s, w, self.p).queries(pc_feat, pc, pc_mask)

    # -- the mixers, one sequence [L, D] at a time -------------------------------
    def conv(self, p, x):
        b, cc, xt = self.lin(x, self.weight(f"{p}.in_proj.weight")).chunk(3, -1)
        bx = b * xt
        w = self.weight(f"{p}.conv.weight")[:, 0]            # [D, taps]
        taps, L = w.shape[1], x.shape[0]
        y = torch.zeros_like(bx)
        for j in range(taps):                                 # y[t] = sum_j w_j bx[t - taps + 1 + j]
            shift = taps - 1 - j
            y[shift:] += w[:, j] * bx[:L - shift]
        return self.lin(cc * y, self.weight(f"{p}.out_proj.weight"))

    def attention(self, p, x):
        c = self.c
        L = x.shape[0]
        H, KV, d = c["num_attention_heads"], c["num_key_value_heads"], head_dim(c)
        q = self.rms(self.lin(x, self.weight(f"{p}.q_proj.weight")).view(L, H, d),
                     self.weight(f"{p}.q_layernorm.weight"))
        k = self.rms(self.lin(x, self.weight(f"{p}.k_proj.weight")).view(L, KV, d),
                     self.weight(f"{p}.k_layernorm.weight"))
        v = self.lin(x, self.weight(f"{p}.v_proj.weight")).view(L, KV, d)
        inv = 1.0 / (rope_theta(c) ** (torch.arange(0, d, 2, device=x.device,
                                                    dtype=torch.float32) / d))
        ang = torch.arange(L, device=x.device, dtype=torch.float32)[:, None] * inv
        cos, sin = torch.cat([ang, ang], -1).cos()[:, None], torch.cat([ang, ang], -1).sin()[:, None]

        def rope(t):
            return t * cos + torch.cat([-t[..., d // 2:], t[..., :d // 2]], -1) * sin
        q, k = rope(q), rope(k)
        kv_of = torch.arange(H, device=x.device) // (H // KV)
        k, v = k[:, kv_of].transpose(0, 1), v[:, kv_of].transpose(0, 1)     # [H, L, d]
        sc = self.p.matmul(q.transpose(0, 1), k.transpose(-1, -2)) / math.sqrt(d)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        att = torch.softmax(sc.masked_fill(~causal, float("-inf")), -1)
        out = self.p.matmul(att, v).transpose(0, 1).reshape(L, H * d)
        return self.lin(out, self.weight(f"{p}.out_proj.weight"))

    # -- the feed-forwards, on every row of every question at once -----------------
    def swiglu(self, x, w1, w3, w2):
        return self.lin(F.silu(self.lin(x, w1)) * self.lin(x, w3), w2)

    def moe(self, f, x):
        c = self.c
        s = torch.sigmoid(self.lin(x, self.weight(f"{f}.gate.weight")))
        pick = s + self.weight(f"{f}.expert_bias") if c["use_expert_bias"] else s
        idx = torch.topk(pick, c["num_experts_per_tok"], dim=-1).indices
        if self.routes is not None:             # the rows of every question, in order
            self.routes.append((idx, pick))
        w = s.gather(-1, idx)
        if c["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-6)
        w = w * c["routed_scaling_factor"]
        w1, w3, w2 = (self.weight(f"{f}.experts.{n}") for n in ("w1", "w3", "w2"))
        out = torch.zeros_like(x)
        for e in torch.unique(idx).tolist():
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            out.index_add_(0, rows, w[rows, slot, None] * self.swiglu(x[rows], w1[e], w3[e], w2[e]))
        return out

    def layer(self, i: int, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        c, p = self.c, f"lfm2.layers.{i}"
        self._held = {n: t for n, t in self._held.items() if n == "lfm2.embed_tokens.weight"}
        norm = self.weight(f"{p}.operator_norm.weight")
        if c["layer_types"][i] == "conv":
            xs = [x + self.conv(f"{p}.conv", self.rms(x, norm)) for x in xs]
        else:
            xs = [x + self.attention(f"{p}.self_attn", self.rms(x, norm)) for x in xs]
        lens = [x.shape[0] for x in xs]
        h = torch.cat(xs)
        f = f"{p}.feed_forward"
        hn = self.rms(h, self.weight(f"{p}.ffn_norm.weight"))
        if i < c["num_dense_layers"]:
            h = h + self.swiglu(hn, *(self.weight(f"{f}.{n}.weight") for n in ("w1", "w3", "w2")))
        else:
            h = h + self.moe(f, hn)
        return list(h.split(lens))

    def logits(self, batch: dict, prompts: List[torch.Tensor], served: List[torch.Tensor]
               ) -> List[torch.Tensor]:
        """float32 [len(served[b]), vocab] for each row b of ``batch``'s
        scenes: the logits that predict each served token, the sequence being
        [queries ; prompts[b] ; served[b] but its last]."""
        q = self.queries(batch["pc_feat"], batch["pc"], batch["pc_mask"])
        emb = self.weight("lfm2.embed_tokens.weight")
        xs = [torch.cat([q[b], emb[prompts[b].long()], emb[served[b][:-1].long()]])
              for b in range(len(prompts))]
        for i in range(len(self.c["layer_types"])):
            xs = self.layer(i, xs)
        self._held = {n: t for n, t in self._held.items() if n == "lfm2.embed_tokens.weight"}
        norm = self.weight("lfm2.embedding_norm.weight")
        return [self.lin(self.rms(x[-len(t):], norm), emb) for x, t in zip(xs, served)]
