"""Model FLOPs of the 3D-LLM answering a question by greedy decoding, from
the configuration's settings ``s``: the Q-Former over the question's valid
scene tokens, ``t5_proj``, the T5 encoder over the 32 queries and the
prompt's real tokens, and for each generated token one decoder step. The
work required is counted, whatever the program does: the encoder output's
cross-attention keys and values once a question (the program projects them
again each step), self-attention over the tokens so far."""
from __future__ import annotations


def qformer_flops(s: dict, n_scene: int) -> float:
    H, I, nq = s["qformer.hidden_size"], s["qformer.intermediate_size"], s["qformer.num_query_tokens"]
    W, freq, nl = s["qformer.encoder_width"], s["qformer.cross_attention_freq"], s["qformer.num_layers"]
    total = 0.0
    for i in range(nl):
        total += 8.0 * nq * H * H + 4.0 * nq * nq * H          # self-attention
        if i % freq == 0:                                       # cross-attention
            total += 4.0 * nq * H * H + 4.0 * n_scene * W * H + 4.0 * nq * n_scene * H
        total += 4.0 * nq * H * I                               # query FFN
    return total + 2.0 * nq * H * s["t5.d_model"]               # t5_proj


def t5_encoder_flops(s: dict, n: int) -> float:
    D, inner, F = s["t5.d_model"], s["t5.num_heads"] * s["t5.d_kv"], s["t5.d_ff"]
    per = 8.0 * n * D * inner + 4.0 * n * n * inner + 6.0 * n * D * F
    return s["t5.num_layers"] * per


def decode_flops(s: dict, n_enc: int, generated: int) -> float:
    """``generated`` decoder steps attending to ``n_enc`` encoder positions."""
    D, inner, F = s["t5.d_model"], s["t5.num_heads"] * s["t5.d_kv"], s["t5.d_ff"]
    V, nl = s["t5.vocab_size"], s["t5.num_decoder_layers"]
    total = nl * 4.0 * n_enc * D * inner                        # cross K/V once
    for t in range(1, generated + 1):
        step = 8.0 * D * inner + 4.0 * t * inner                # self-attention
        step += 4.0 * D * inner + 4.0 * n_enc * inner           # cross-attention q, o
        step += 6.0 * D * F
        total += nl * step + 2.0 * D * V
    return total


def question_flops(s: dict, n_scene: int, n_prompt: int, generated: int) -> float:
    n_enc = s["qformer.num_query_tokens"] + n_prompt
    return (qformer_flops(s, n_scene) + t5_encoder_flops(s, n_enc)
            + decode_flops(s, n_enc, generated))
