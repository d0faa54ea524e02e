"""Model FLOPs and least times of the 3D-LLM with a Nemotron-H language model
answering a question by greedy decoding, from the configuration's settings
``s`` (``reference/nemotron_h.py:settings``). The work required is counted,
whatever the program does.

- :func:`question_flops`: the Q-Former over the question's scene tokens and
  ``nemotron_proj`` (``flops/blip2.py``), the LM's prefill over the 32
  queries and the prompt's real tokens, one decode step for each generated
  token but the last. A token's products count its 6 routed experts (two
  matrices each), the shared expert, the router, the Mamba mixers'
  projections, conv and recurrence; attention counts the causal keys; the
  head one row a generated token.
- :func:`moe_least_s`: the expert layer's least time, as ``flops/moe.py``
  reckons LFM2's, but with **two** matrices an expert (``up`` and ``down``),
  so ``moe_roofline.answer`` reads the same work whatever kernel computes it.
- :func:`ssm_least_s`: the recurrence kernels' least time, from the device
  counters of ``ops/cuda/ssm_scan.py``.
"""
from __future__ import annotations

from benchmarks.flops import blip2
from benchmarks.flops.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from benchmarks.reference.nemotron_h import lm, widths

F32 = 4


def ssm_ops_per_token(c: dict) -> float:
    """The recurrence's operations a position, all heads: ``4 * head_dim *
    state`` a head (the decayed state plus the outer product, then ``S C``)."""
    H, P, _, N, _ = widths(c)
    return 4.0 * H * P * N


def layer_flops(c: dict, kind: str, tokens: int, keys: int) -> float:
    """One layer of ``kind`` over ``tokens`` positions that attend to ``keys``
    keys in all."""
    D = c["hidden_size"]
    if kind == "M":
        H, P, G, N, conv = widths(c)
        per = (2.0 * D * (H * P + conv + H) + 2.0 * c["conv_kernel"] * conv
               + ssm_ops_per_token(c) + 2.0 * H * P * D)
        return tokens * per
    if kind == "*":
        H, KV, d = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        return tokens * (2.0 * D * (H + 2 * KV) * d + 2.0 * H * d * D) + 4.0 * keys * H * d
    E, M, S = (c["n_routed_experts"], c["moe_intermediate_size"],
               c["moe_shared_expert_intermediate_size"])
    return tokens * (2.0 * D * E + c["num_experts_per_tok"] * 4.0 * D * M + 4.0 * D * S)


def lm_flops(s: dict, n_prefix: int, generated: int) -> float:
    c = lm(s)
    fed = n_prefix + max(generated - 1, 0)          # every position fed, causal keys
    keys = fed * (fed + 1) // 2
    head = 2.0 * c["hidden_size"] * c["vocab_size"]
    return (sum(layer_flops(c, k, fed, keys) for k in c["hybrid_override_pattern"])
            + generated * head)


def question_flops(s: dict, n_scene: int, n_prompt: int, generated: int) -> float:
    nq = s["qformer.num_query_tokens"]
    scene = blip2.qformer_flops({**s, "t5.d_model": lm(s)["hidden_size"]}, n_scene)
    return scene + lm_flops(s, nq + n_prompt, generated)


def moe_least_s(experts_read: float, rows_routed: float, hidden: int, width: int, top_k: int
                ) -> float:
    """``experts_read`` (call, expert) pairs each streaming its two bfloat16
    matrices once; ``rows_routed`` assignments, each one product through
    ``up`` and one through ``down``; each routed token's row read once in
    bfloat16 and its float32 sum written once."""
    tokens = rows_routed / top_k
    nbytes = experts_read * 2 * hidden * width * 2 + tokens * hidden * (2 + 4)
    return max(nbytes / HBM_BYTES_PER_S, rows_routed * 2 * 2 * hidden * width / BF16_FLOPS)


def ssm_least_s(s: dict, scanned: float, stepped: float, prefill_rows: float) -> float:
    """The least time of the recurrence kernels over ``scanned`` prefill
    positions, ``stepped`` decode rows and ``prefill_rows`` (row, layer)
    prefills, all summed over the SSM layers: the larger of

    - bytes over HBM bandwidth: each position's (or decode row's) x, B, C
      and dt read once and y written once, float32 as the program holds
      them; the state written once a prefill row, read and written once a
      decode row;
    - operations (``4 * head_dim * state`` a position and head) over the
      bfloat16 peak."""
    c = lm(s)
    H, P, G, N, conv = widths(c)
    per_position = (conv + H + H * P) * F32
    state = H * P * N * F32
    nbytes = ((scanned + stepped) * per_position + prefill_rows * state
              + stepped * 2 * state)
    return max(nbytes / HBM_BYTES_PER_S,
               (scanned + stepped) * ssm_ops_per_token(c) / BF16_FLOPS)
