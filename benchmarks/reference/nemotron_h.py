"""Plain PyTorch reference of the 3D-LLM with a Nemotron-H language model
(``nemotron_h``, as Hugging Face's ``NemotronH`` modelling code describes it):

- the scene's 32 queries: ``reference/blip2.py``'s Q-Former (features plus
  0.01 x the voxel encoding), then ``nemotron_proj`` to the LM's width;
- each question alone, unpadded, as one causal sequence [queries ; prompt
  tokens ; served tokens], teacher-forced in one full forward: no cache, no
  batching, no kernels;
- a layer ``x = x + mixer(rms(x))``, the mixer named by the layer's letter
  of ``hybrid_override_pattern``, RMS norms ``x * rsqrt(mean x^2 + eps) *
  w``:
  - ``M``, Mamba-2: ``z, xBC, dt = split(in_proj x)``; ``xBC = silu(conv(xBC)
    + conv_bias)``, a causal depthwise conv of ``conv_kernel`` taps; ``x, B,
    C = split(xBC)``, head ``h`` reading group ``h // (heads / n_groups)``;
    ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; then, **one
    position at a time**, ``S = exp(dt A) S + dt x B^T`` and ``y = S C + D
    x``; ``y = rms(y * silu(z))`` over ``n_groups`` groups of channels,
    times the norm's weight; ``out_proj``;
  - ``*``, attention: GQA with no positional encoding and no q / k norms,
    causal softmax at ``1/sqrt(head_dim)``, ``o_proj``;
  - ``E``, experts: ``sum_k w_k * down_e(relu(up_e x)^2)`` over the experts
    ``top_k(sigmoid(gate x) + e_score_correction_bias)``, ``w_k`` each
    chosen expert's sigmoid over their sum plus 1e-20, times
    ``routed_scaling_factor``; plus the shared expert ``down(relu(up x)^2)``;
- ``norm_f``, then the untied ``lm_head``.

Departures from the modelling code: float32 throughout, TF32 off (the
model is published in bfloat16); the weights are the benchmark's random
draws (:func:`make_weight`). Products run in ``precision``
(``reference/precision.py``). The recurrence runs position by position, not
in Mamba-2's chunked form, so it checks the program's scan independently.
The model runs a layer at a time over all the questions given: each layer's
weights are made, used and dropped, as ``reference/lfm2.py`` does. Imports
nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmarks.reference import blip2
from benchmarks.reference.lfm2 import _NO_T5, LFM2Reference, Weight
from benchmarks.reference.precision import Exact, exact_float32
from benchmarks.reference.weights_by_tensor import make_tensor, tensor_seed

PREFIX = "nemotron_h."
ROUTER_EPS = 1e-20

# the keys of Nemotron-3-Nano-30B-A3B's published config.json, which a
# configuration file holds at its top level
PUBLISHED = (
    "attention_bias", "chunk_size", "conv_kernel", "expand", "head_dim", "hidden_size",
    "hybrid_override_pattern", "intermediate_size", "layer_norm_epsilon", "mamba_head_dim",
    "mamba_hidden_act", "mamba_num_heads", "mamba_proj_bias", "max_position_embeddings",
    "mlp_bias", "mlp_hidden_act", "model_type", "moe_intermediate_size",
    "moe_shared_expert_intermediate_size", "n_group", "n_groups", "n_routed_experts",
    "n_shared_experts", "norm_eps", "norm_topk_prob", "num_attention_heads",
    "num_experts_per_tok", "num_hidden_layers", "num_key_value_heads", "num_logits_to_keep",
    "partial_rotary_factor", "rescale_prenorm_residual", "residual_in_fp32", "rope_theta",
    "routed_scaling_factor", "sliding_window", "ssm_state_size", "tie_word_embeddings",
    "time_step_floor", "time_step_max", "time_step_min", "topk_group", "use_bias",
    "use_conv_bias", "use_mamba_kernels", "vocab_size")


def settings(config: dict) -> dict:
    """A configuration's settings with its published keys folded in as
    ``nemotron_h.<key>``; a key the settings name themselves wins."""
    return {**{PREFIX + k: config[k] for k in PUBLISHED if k in config}, **config["settings"]}


def lm(s: dict) -> dict:
    """The language model's settings, ``nemotron_h.`` stripped."""
    return {k[len(PREFIX):]: v for k, v in s.items() if k.startswith(PREFIX)}


def widths(c: dict) -> Tuple[int, int, int, int, int]:
    """(heads, head_dim, groups, state, conv channels) of the Mamba mixer."""
    H, P, G, N = c["mamba_num_heads"], c["mamba_head_dim"], c["n_groups"], c["ssm_state_size"]
    return H, P, G, N, H * P + 2 * G * N


def param_spec(s: dict) -> Dict[str, Tuple[int, ...]]:
    c = lm(s)
    D, V = c["hidden_size"], c["vocab_size"]
    H, P, G, N, conv = widths(c)
    Ha, KV, d = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    E, M, Sh = c["n_routed_experts"], c["moe_intermediate_size"], \
        c["moe_shared_expert_intermediate_size"]
    spec = {n: v for n, v in blip2.param_spec({**s, **_NO_T5}).items() if n.startswith("qformer.")}
    spec["nemotron_proj.weight"], spec["nemotron_proj.bias"] = (D, s["qformer.hidden_size"]), (D,)
    spec["nemotron_h.embeddings.weight"] = (V, D)
    for i, kind in enumerate(c["hybrid_override_pattern"]):
        p = f"nemotron_h.layers.{i}"
        spec[f"{p}.norm.weight"] = (D,)
        m = f"{p}.mixer"
        if kind == "M":
            spec[f"{m}.in_proj.weight"] = (H * P + conv + H, D)
            spec[f"{m}.conv1d.weight"] = (conv, 1, c["conv_kernel"])
            if c["use_conv_bias"]:
                spec[f"{m}.conv1d.bias"] = (conv,)
            spec[f"{m}.dt_bias"] = spec[f"{m}.A_log"] = spec[f"{m}.D"] = (H,)
            spec[f"{m}.norm.weight"] = (H * P,)
            spec[f"{m}.out_proj.weight"] = (D, H * P)
        elif kind == "*":
            spec[f"{m}.q_proj.weight"], spec[f"{m}.o_proj.weight"] = (Ha * d, D), (D, Ha * d)
            spec[f"{m}.k_proj.weight"] = spec[f"{m}.v_proj.weight"] = (KV * d, D)
        else:
            spec[f"{m}.gate.weight"], spec[f"{m}.e_score_correction_bias"] = (E, D), (E,)
            spec[f"{m}.experts.up"], spec[f"{m}.experts.down"] = (E, M, D), (E, D, M)
            spec[f"{m}.shared_experts.up_proj.weight"] = (Sh, D)
            spec[f"{m}.shared_experts.down_proj.weight"] = (D, Sh)
    spec["nemotron_h.norm_f.weight"] = (D,)
    spec["nemotron_h.lm_head.weight"] = (V, D)
    return spec


@torch.no_grad()
def make_weight(name: str, shape, seed: int, device, dtype: torch.dtype, config: dict
                ) -> torch.Tensor:
    """The tensor ``name``: ``reference/weights_by_tensor.py``'s draw, but
    for the SSM's ``A_log = log U[1, 16]`` and ``dt_bias``, the inverse
    softplus of a step size log-uniform in [time_step_min, time_step_max]
    and floored at time_step_floor, as Mamba-2 initialises them; rounded to
    bfloat16 like every other value."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("A_log", "dt_bias"):
        g = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
        u = torch.rand(tuple(shape), generator=g, device=device, dtype=torch.float64)
        if leaf == "A_log":
            t = torch.log(1 + 15 * u)
        else:
            lo, hi = math.log(config["time_step_min"]), math.log(config["time_step_max"])
            dt = torch.exp(u * (hi - lo) + lo).clamp(min=config["time_step_floor"])
            t = dt + torch.log(-torch.expm1(-dt))
        return t.to(torch.bfloat16).to(dtype)
    return make_tensor(name, shape, seed, device, dtype, config.get("init_scale"),
                       config.get("init_normal"), config.get("init_shared"))


class NemotronHReference(LFM2Reference):
    """``reference/lfm2.py``'s layer-at-a-time runner (its weight cache, RMS
    norm, products and route record) over Nemotron-H's layers."""

    def __init__(self, s: dict, weight: Weight, precision: Exact = None):
        exact_float32()                 # TF32 off: a float32 product is a float32 product
        self.s, self.c, self.p = s, lm(s), precision or Exact()
        self.c["norm_eps"] = self.c["layer_norm_epsilon"]      # the RMS helper's key
        self._make, self._held = weight, {}
        self.routes: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None

    def queries(self, pc_feat, pc, pc_mask) -> torch.Tensor:
        names = [n for n in param_spec(self.s) if n.startswith(("qformer.", "nemotron_proj."))]
        w = {n.replace("nemotron_proj", "t5_proj"): self.weight(n) for n in names}
        return blip2.Blip2Reference(self.s, w, self.p).queries(pc_feat, pc, pc_mask)

    # -- the mixers, one sequence [L, D] at a time -------------------------------
    def mamba(self, m: str, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        H, P, G, N, conv = widths(c)
        L = x.shape[0]
        z, xbc, dt = self.lin(x, self.weight(f"{m}.in_proj.weight")).split([H * P, conv, H], -1)
        w = self.weight(f"{m}.conv1d.weight")[:, 0]              # [conv, taps]
        taps = w.shape[1]
        y = torch.zeros_like(xbc)
        for j in range(taps):                                    # y[t] = sum_j w_j u[t - taps + 1 + j]
            shift = taps - 1 - j
            y[shift:] += w[:, j] * xbc[:L - shift]
        if c["use_conv_bias"]:
            y = y + self.weight(f"{m}.conv1d.bias")
        xs, Bm, Cm = F.silu(y).split([H * P, G * N, G * N], -1)
        xs = xs.view(L, H, P)
        group = torch.arange(H, device=x.device) // (H // G)
        Bm, Cm = Bm.view(L, G, N)[:, group], Cm.view(L, G, N)[:, group]       # [L, H, N]
        dt = F.softplus(dt + self.weight(f"{m}.dt_bias"))
        A, Dh = -torch.exp(self.weight(f"{m}.A_log")), self.weight(f"{m}.D")
        S = x.new_zeros(H, P, N)
        ys = []
        for t in range(L):
            S = (torch.exp(dt[t] * A)[:, None, None] * S
                 + (dt[t][:, None] * xs[t])[..., None] * Bm[t][:, None, :])
            ys.append(self.p.matmul(S, Cm[t][..., None])[..., 0] + Dh[:, None] * xs[t])
        g = (torch.stack(ys).reshape(L, H * P) * F.silu(z)).view(L, G, -1)
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + c["layer_norm_epsilon"])
        out = g.reshape(L, H * P) * self.weight(f"{m}.norm.weight")
        return self.lin(out, self.weight(f"{m}.out_proj.weight"))

    def nope_attention(self, m: str, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        L = x.shape[0]
        H, KV, d = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        q = self.lin(x, self.weight(f"{m}.q_proj.weight")).view(L, H, d)
        k = self.lin(x, self.weight(f"{m}.k_proj.weight")).view(L, KV, d)
        v = self.lin(x, self.weight(f"{m}.v_proj.weight")).view(L, KV, d)
        kv_of = torch.arange(H, device=x.device) // (H // KV)
        k, v = k[:, kv_of].transpose(0, 1), v[:, kv_of].transpose(0, 1)     # [H, L, d]
        sc = self.p.matmul(q.transpose(0, 1), k.transpose(-1, -2)) / math.sqrt(d)
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        att = torch.softmax(sc.masked_fill(~causal, float("-inf")), -1)
        out = self.p.matmul(att, v).transpose(0, 1).reshape(L, H * d)
        return self.lin(out, self.weight(f"{m}.o_proj.weight"))

    # -- the experts, on every row of every question at once ----------------------
    def relu2(self, x, up, down):
        return self.lin(F.relu(self.lin(x, up)).square(), down)

    def experts(self, m: str, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        s = torch.sigmoid(self.lin(x, self.weight(f"{m}.gate.weight")))
        pick = s + self.weight(f"{m}.e_score_correction_bias")
        idx = torch.topk(pick, c["num_experts_per_tok"], dim=-1).indices
        if self.routes is not None:             # the rows of every question, in order
            self.routes.append((idx, pick))
        w = s.gather(-1, idx)
        if c["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + ROUTER_EPS)
        w = w * c["routed_scaling_factor"]
        up, down = self.weight(f"{m}.experts.up"), self.weight(f"{m}.experts.down")
        out = torch.zeros_like(x)
        for e in torch.unique(idx).tolist():
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            out.index_add_(0, rows, w[rows, slot, None] * self.relu2(x[rows], up[e], down[e]))
        return out + self.relu2(x, self.weight(f"{m}.shared_experts.up_proj.weight"),
                                self.weight(f"{m}.shared_experts.down_proj.weight"))

    def layer(self, i: int, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        p = f"nemotron_h.layers.{i}"
        self._held = {}
        norm, m = self.weight(f"{p}.norm.weight"), f"{p}.mixer"
        kind = self.c["hybrid_override_pattern"][i]
        if kind == "M":
            return [x + self.mamba(m, self.rms(x, norm)) for x in xs]
        if kind == "*":
            return [x + self.nope_attention(m, self.rms(x, norm)) for x in xs]
        lens = [x.shape[0] for x in xs]
        h = torch.cat(xs)
        return list((h + self.experts(m, self.rms(h, norm))).split(lens))

    def logits(self, batch: dict, prompts: List[torch.Tensor], served: List[torch.Tensor]
               ) -> List[torch.Tensor]:
        """float32 [len(served[b]), vocab] for each row b of ``batch``'s
        scenes: the logits that predict each served token, the sequence being
        [queries ; prompts[b] ; served[b] but its last]."""
        q = self.queries(batch["pc_feat"], batch["pc"], batch["pc_mask"])
        emb = self.weight("nemotron_h.embeddings.weight")
        xs = [torch.cat([q[b], emb[prompts[b].long()], emb[served[b][:-1].long()]])
              for b in range(len(prompts))]
        del emb
        for i in range(len(self.c["hybrid_override_pattern"])):
            xs = self.layer(i, xs)
        self._held = {}
        norm, head = self.weight("nemotron_h.norm_f.weight"), self.weight("nemotron_h.lm_head.weight")
        out = [self.lin(self.rms(x[-len(t):], norm), head) for x, t in zip(xs, served)]
        self._held = {}
        return out
