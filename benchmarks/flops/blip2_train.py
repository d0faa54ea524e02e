"""Model FLOPs of one 3D-LLM training sample (``flops/blip2.py``'s forward,
with SIG3D's convention for the backward): the Q-Former and ``t5_proj``
are trained, three times their forward (``dx`` and ``dW`` besides); the
frozen T5 encoder and decoder pass the gradient through to the queries, two
times their forward (``dx`` only); the trained ``lm_head`` three times its
forward; the trained input embedding is a lookup. The decoder runs
teacher-forced over the answer's tokens."""
from __future__ import annotations

from benchmarks.flops import blip2


def sample_flops(s: dict, n_scene: int, n_prompt: int, n_answer: int) -> float:
    n_enc = s["qformer.num_query_tokens"] + n_prompt
    head = n_answer * 2.0 * s["t5.d_model"] * s["t5.vocab_size"]
    frozen = blip2.t5_encoder_flops(s, n_enc) + blip2.decode_flops(s, n_enc, n_answer) - head
    return 3.0 * blip2.qformer_flops(s, n_scene) + 2.0 * frozen + 3.0 * head
