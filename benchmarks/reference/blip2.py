"""Plain PyTorch reference of the 3D-LLM's answering (BLIP-2 Q-Former +
FlanT5), from the models' descriptions:

- scene tokens: the features plus 0.01 x a sinusoidal encoding of each voxel
  axis (``PositionalEncoding1D(1408 // 3)`` over 256 positions: interleaved
  sin / cos, truncated to 469 channels; three axes, zero-padded to 1408);
- the Q-Former: 32 learned queries, post-LN BERT layers (eps 1e-12),
  cross-attention into the scene tokens every second layer, the query FFN;
  ``t5_proj`` to the T5 width;
- FlanT5: RMS norms, no 1/sqrt(d) scaling, one relative position bias
  (layer 0's, bidirectional in the encoder, causal in the decoder), gated
  GELU FFN, an untied ``lm_head``; the encoder over [queries ; prompt], the
  decoder teacher-forced over [start ; served tokens].

It reads the served tokens only as the positions to judge. Float32, products
in ``precision``. Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.reference.precision import Exact
from benchmarks.reference.sig3d import NEG_INF, t5_bucket


def param_spec(s: dict) -> Dict[str, Tuple[int, ...]]:
    spec: Dict[str, Tuple[int, ...]] = {}
    H, I, W = s["qformer.hidden_size"], s["qformer.intermediate_size"], s["qformer.encoder_width"]
    spec["qformer.query_tokens"] = (1, s["qformer.num_query_tokens"], H)
    spec["qformer.emb_norm.weight"], spec["qformer.emb_norm.bias"] = (H,), (H,)

    def attn(p, kv):
        for n, i in (("query", H), ("key", kv), ("value", kv), ("out_dense", H)):
            spec[f"{p}.{n}.weight"], spec[f"{p}.{n}.bias"] = (H, i), (H,)
        spec[f"{p}.out_norm.weight"], spec[f"{p}.out_norm.bias"] = (H,), (H,)

    for i in range(s["qformer.num_layers"]):
        p = f"qformer.layer{i}"
        attn(f"{p}.attention", H)
        if i % s["qformer.cross_attention_freq"] == 0:
            attn(f"{p}.crossattention", W)
        spec[f"{p}.intermediate_query.weight"], spec[f"{p}.intermediate_query.bias"] = (I, H), (I,)
        spec[f"{p}.output_query.weight"], spec[f"{p}.output_query.bias"] = (H, I), (H,)
        spec[f"{p}.output_query_norm.weight"], spec[f"{p}.output_query_norm.bias"] = (H,), (H,)
    D, inner, Fd, V = s["t5.d_model"], s["t5.num_heads"] * s["t5.d_kv"], s["t5.d_ff"], s["t5.vocab_size"]
    spec["t5.shared.weight"] = (V, D)
    spec["t5.lm_head.weight"] = (V, D)

    def t5_attn(p, bias):
        for n in "qkv":
            spec[f"{p}.{n}.weight"] = (inner, D)
        spec[f"{p}.o.weight"] = (D, inner)
        if bias:
            spec[f"{p}.relative_attention_bias.weight"] = (s["t5.relative_attention_num_buckets"],
                                                          s["t5.num_heads"])

    def ff(p):
        spec[f"{p}.layer_norm.weight"] = (D,)
        spec[f"{p}.wi_0.weight"], spec[f"{p}.wi_1.weight"] = (Fd, D), (Fd, D)
        spec[f"{p}.wo.weight"] = (D, Fd)

    for i in range(s["t5.num_layers"]):
        p = f"t5.encoder.block{i}"
        spec[f"{p}.self_attn_norm.weight"] = (D,)
        t5_attn(f"{p}.self_attn", i == 0)
        ff(f"{p}.ff")
    spec["t5.encoder.final_norm.weight"] = (D,)
    for i in range(s["t5.num_decoder_layers"]):
        p = f"t5.decoder.block{i}"
        spec[f"{p}.self_attn_norm.weight"] = (D,)
        t5_attn(f"{p}.self_attn", i == 0)
        spec[f"{p}.cross_attn_norm.weight"] = (D,)
        t5_attn(f"{p}.cross_attn", False)
        ff(f"{p}.ff")
    spec["t5.decoder.final_norm.weight"] = (D,)
    spec["t5_proj.weight"], spec["t5_proj.bias"] = (D, H), (D,)
    return spec


def position_table(channels: int, n_pos: int = 256) -> np.ndarray:
    c2 = channels + channels % 2
    inv = 1.0 / (10000 ** (np.arange(0, c2, 2, dtype=np.float64) / c2))
    ang = np.arange(n_pos, dtype=np.float64)[:, None] * inv[None]
    t = np.zeros((n_pos, c2), np.float32)
    t[:, 0::2], t[:, 1::2] = np.sin(ang), np.cos(ang)
    return t[:, :channels]


class Blip2Reference:
    def __init__(self, s: dict, w: Dict[str, torch.Tensor], precision: Exact = None):
        self.s, self.w, self.p = s, w, precision or Exact()

    def dense(self, name, x):
        return self.p.linear(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"))

    def ln(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            self.s["qformer.layer_norm_eps"])

    def rms(self, name, x):
        var = x.square().mean(-1, keepdim=True)
        return self.w[f"{name}.weight"] * (x * torch.rsqrt(var + self.s["t5.layer_norm_epsilon"]))

    # -- scene encoder ---------------------------------------------------------
    def bert_attn(self, p, x, kv, kv_mask):
        s = self.s
        B, L, H = x.shape
        h = s["qformer.num_heads"]
        d = H // h

        def split(t):
            return t.reshape(B, -1, h, d).transpose(1, 2)
        q = split(self.dense(f"{p}.query", x))
        k, v = split(self.dense(f"{p}.key", kv)), split(self.dense(f"{p}.value", kv))
        sc = self.p.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        if kv_mask is not None:
            sc = sc.masked_fill(~kv_mask[:, None, None, :].bool(), NEG_INF)
        out = self.p.matmul(torch.softmax(sc, -1), v).transpose(1, 2).reshape(B, L, H)
        return self.ln(f"{p}.out_norm", x + self.dense(f"{p}.out_dense", out))

    def queries(self, pc_feat, pc, pc_mask):
        """The scene's 32 queries in T5 space [B, 32, d_model]."""
        s = self.s
        dim = s["pc_feat_dim"]
        table = torch.from_numpy(position_table(dim // 3)).to(pc_feat.device)
        idx = pc.long().clamp(0, table.shape[0] - 1)
        pos = torch.cat([table[idx[..., i]] for i in range(3)], -1)
        pos = F.pad(pos, (0, dim - pos.shape[-1]))
        scene = pc_feat.float() + s["pos_scale"] * pos
        B = scene.shape[0]
        x = self.ln("qformer.emb_norm", self.w["qformer.query_tokens"].expand(B, -1, -1))
        for i in range(s["qformer.num_layers"]):
            p = f"qformer.layer{i}"
            x = self.bert_attn(f"{p}.attention", x, x, None)
            if i % s["qformer.cross_attention_freq"] == 0:
                x = self.bert_attn(f"{p}.crossattention", x, scene, pc_mask)
            y = self.dense(f"{p}.output_query", F.gelu(self.dense(f"{p}.intermediate_query", x)))
            x = self.ln(f"{p}.output_query_norm", x + y)
        return self.dense("t5_proj", x)

    # -- T5 --------------------------------------------------------------------
    def t5_attn(self, p, x, kv, mask, bias):
        s = self.s
        B, Lq, _ = x.shape
        h, d = s["t5.num_heads"], s["t5.d_kv"]

        def split(t):
            return t.reshape(B, -1, h, d).transpose(1, 2)
        q, k, v = split(self.dense(f"{p}.q", x)), split(self.dense(f"{p}.k", kv)), split(self.dense(f"{p}.v", kv))
        sc = self.p.matmul(q, k.transpose(-1, -2))
        if bias is not None:
            sc = sc + bias
        if mask is not None:
            sc = sc.masked_fill(~mask, NEG_INF)
        out = self.p.matmul(torch.softmax(sc, -1), v).transpose(1, 2).reshape(B, Lq, h * d)
        return self.dense(f"{p}.o", out)

    def ff(self, p, x):
        h = self.rms(f"{p}.layer_norm", x)
        h = F.gelu(self.dense(f"{p}.wi_0", h)) * self.dense(f"{p}.wi_1", h)
        return x + self.dense(f"{p}.wo", h)

    def bias(self, p, Lq, Lk, bidirectional, device):
        s = self.s
        rp = torch.arange(Lk, device=device)[None] - torch.arange(Lq, device=device)[:, None]
        b = t5_bucket(rp, bidirectional, s["t5.relative_attention_num_buckets"],
                      s["t5.relative_attention_max_distance"])
        return self.w[f"{p}.relative_attention_bias.weight"][b].permute(2, 0, 1)[None]

    def encode(self, embeds, mask):
        s = self.s
        n = embeds.shape[1]
        bias = self.bias("t5.encoder.block0.self_attn", n, n, True, embeds.device)
        keep = mask.bool()[:, None, None, :]
        x = embeds
        for i in range(s["t5.num_layers"]):
            p = f"t5.encoder.block{i}"
            x = x + self.t5_attn(f"{p}.self_attn", self.rms(f"{p}.self_attn_norm", x),
                                 self.rms(f"{p}.self_attn_norm", x), keep, bias)
            x = self.ff(f"{p}.ff", x)
        return self.rms("t5.encoder.final_norm", x)

    def decode(self, enc, enc_mask, dec_ids):
        s = self.s
        L = dec_ids.shape[1]
        bias = self.bias("t5.decoder.block0.self_attn", L, L, False, enc.device)
        causal = torch.ones(L, L, dtype=torch.bool, device=enc.device).tril()[None, None]
        keep = enc_mask.bool()[:, None, None, :]
        x = self.w["t5.shared.weight"][dec_ids]
        for i in range(s["t5.num_decoder_layers"]):
            p = f"t5.decoder.block{i}"
            h = self.rms(f"{p}.self_attn_norm", x)
            x = x + self.t5_attn(f"{p}.self_attn", h, h, causal, bias)
            x = x + self.t5_attn(f"{p}.cross_attn", self.rms(f"{p}.cross_attn_norm", x), enc, keep, None)
            x = self.ff(f"{p}.ff", x)
        return self.dense("t5.lm_head", self.rms("t5.decoder.final_norm", x))

    def logits(self, batch, served: torch.Tensor) -> torch.Tensor:
        """float32 [B, T, vocab]: the logits at each served position, the
        decoder fed the start token and the served tokens before it."""
        s = self.s
        q = self.queries(batch["pc_feat"], batch["pc"], batch["pc_mask"])
        tok = self.w["t5.shared.weight"][batch["input_ids"].long()]
        embeds = torch.cat([q, tok], 1)
        mask = torch.cat([torch.ones(q.shape[:2], device=q.device, dtype=batch["input_mask"].dtype),
                          batch["input_mask"]], 1)
        enc = self.encode(embeds, mask)
        start = torch.full_like(served[:, :1], s["t5.decoder_start_token_id"])
        return self.decode(enc, mask, torch.cat([start, served[:, :-1]], 1))


def served_positions(tokens: torch.Tensor, eos: int) -> torch.Tensor:
    """bool [B, T]: the positions a greedy decode served (up to and with
    its first end token)."""
    is_eos = (tokens == eos).int()
    before = torch.cumsum(is_eos, 1) - is_eos
    return before == 0


def logit_gap(logits: torch.Tensor, tokens: torch.Tensor, served: torch.Tensor) -> float:
    """The widest gap by which a served token's logit lies below the best."""
    gap = logits.max(-1).values - logits.gather(-1, tokens[..., None].long())[..., 0]
    return float(gap[served].max()) if served.any() else 0.0
