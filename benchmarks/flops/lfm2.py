"""Model FLOPs of the 3D-LLM with an LFM2-MoE language model answering a
question by greedy decoding, from the configuration's settings ``s``: the
Q-Former over the question's scene tokens and ``lfm2_proj``
(``flops/blip2.py``), the LM's prefill over the 32 queries and the prompt's
real tokens, and one decode step for each generated token but the last. A
token's products count 4 active experts (``num_experts_per_tok``) and the
router; attention counts the causal keys; the head counts one row a
generated token. The work required is counted, whatever the program does."""
from __future__ import annotations

from benchmarks.flops import blip2


def layer_flops(s: dict, i: int, tokens: int, keys: int) -> float:
    """Layer ``i`` over ``tokens`` positions that attend to ``keys`` keys in
    all."""
    D = s["lfm2.hidden_size"]
    H, KV = s["lfm2.num_attention_heads"], s["lfm2.num_key_value_heads"]
    d = D // H
    if s["lfm2.layer_types"][i] == "conv":
        mix = tokens * (2.0 * D * 3 * D + 2.0 * D * D + 2.0 * s["lfm2.conv_L_cache"] * D)
    else:
        mix = tokens * (2.0 * D * (H + 2 * KV) * d + 2.0 * H * d * D) + 4.0 * keys * H * d
    if i < s["lfm2.num_dense_layers"]:
        ff = 6.0 * D * s["lfm2.intermediate_size"]
    else:
        ff = (2.0 * D * s["lfm2.num_experts"]
              + s["lfm2.num_experts_per_tok"] * 6.0 * D * s["lfm2.moe_intermediate_size"])
    return mix + tokens * ff


def lm_flops(s: dict, n_prefix: int, generated: int) -> float:
    fed = n_prefix + max(generated - 1, 0)          # every position fed, causal keys
    keys = fed * (fed + 1) // 2
    head = 2.0 * s["lfm2.hidden_size"] * s["lfm2.vocab_size"]
    return (sum(layer_flops(s, i, fed, keys) for i in range(len(s["lfm2.layer_types"])))
            + generated * head)


def question_flops(s: dict, n_scene: int, n_prompt: int, generated: int) -> float:
    nq = s["qformer.num_query_tokens"]
    scene = blip2.qformer_flops({**s, "t5.d_model": s["lfm2.hidden_size"]}, n_scene)
    return scene + lm_flops(s, nq + n_prompt, generated)
