"""HF T5 checkpoint -> the T5 tree (port of
``situation3d_tpu/ckpt_compat/t5.py``).

Maps ``google/flan-t5-xl`` state-dict names into the tree of
``models/t5.py``, with the Blip2T5 vocabulary resize: 32128 rows + 32768
``<loc*>`` tokens, padded up to the configured vocabulary size.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from situation3d_tpu_torch.ckpt_compat.common import linear_kernel


def _resize_rows(w: np.ndarray, rows: int, rng: Optional[np.random.RandomState]
                 ) -> np.ndarray:
    if len(w) >= rows:
        return w[:rows]
    extra_shape = (rows - len(w),) + w.shape[1:]
    if rng is None:
        extra = np.zeros(extra_shape, w.dtype)
    else:  # HF resize initializes new token rows from N(0, 0.02)
        extra = (rng.randn(*extra_shape) * 0.02).astype(w.dtype)
    return np.concatenate([w, extra], axis=0)


def _attn(sd, base, with_bias=False):
    out = {
        "q": {"kernel": linear_kernel(sd, f"{base}.q")},
        "k": {"kernel": linear_kernel(sd, f"{base}.k")},
        "v": {"kernel": linear_kernel(sd, f"{base}.v")},
        "o": {"kernel": linear_kernel(sd, f"{base}.o")},
    }
    rel = f"{base}.relative_attention_bias.weight"
    if rel in sd:
        out["relative_attention_bias"] = {"embedding": sd[rel]}
    return out


def _ff(sd, base, gated=True):
    if gated:
        return {
            "wi_0": {"kernel": linear_kernel(sd, f"{base}.wi_0")},
            "wi_1": {"kernel": linear_kernel(sd, f"{base}.wi_1")},
            "wo": {"kernel": linear_kernel(sd, f"{base}.wo")},
        }
    return {"wi": {"kernel": linear_kernel(sd, f"{base}.wi")},
            "wo": {"kernel": linear_kernel(sd, f"{base}.wo")}}


def _ln(sd, name):
    return {"weight": sd[f"{name}.weight"]}


def convert_t5(sd: Dict[str, np.ndarray], num_layers: int,
               num_decoder_layers: int, vocab_size: int,
               gated: bool = True, seed: int = 0) -> Dict[str, Any]:
    rng = np.random.RandomState(seed)
    p: Dict[str, Any] = {
        "shared": {"embedding": _resize_rows(sd["shared.weight"], vocab_size, rng)},
    }
    if "lm_head.weight" in sd:
        p["lm_head"] = {
            "kernel": _resize_rows(sd["lm_head.weight"], vocab_size, rng).T}

    enc: Dict[str, Any] = {}
    for i in range(num_layers):
        b = f"encoder.block.{i}"
        enc[f"block{i}"] = {
            "self_attn": _attn(sd, f"{b}.layer.0.SelfAttention"),
            "self_attn_norm": _ln(sd, f"{b}.layer.0.layer_norm"),
            "ff": {**_ff(sd, f"{b}.layer.1.DenseReluDense", gated),
                   "layer_norm": _ln(sd, f"{b}.layer.1.layer_norm")},
        }
    enc["final_norm"] = _ln(sd, "encoder.final_layer_norm")
    p["encoder"] = enc

    dec: Dict[str, Any] = {}
    for i in range(num_decoder_layers):
        b = f"decoder.block.{i}"
        dec[f"block{i}"] = {
            "self_attn": _attn(sd, f"{b}.layer.0.SelfAttention"),
            "self_attn_norm": _ln(sd, f"{b}.layer.0.layer_norm"),
            "cross_attn": _attn(sd, f"{b}.layer.1.EncDecAttention"),
            "cross_attn_norm": _ln(sd, f"{b}.layer.1.layer_norm"),
            "ff": {**_ff(sd, f"{b}.layer.2.DenseReluDense", gated),
                   "layer_norm": _ln(sd, f"{b}.layer.2.layer_norm")},
        }
    dec["final_norm"] = _ln(sd, "decoder.final_layer_norm")
    p["decoder"] = dec
    return p
