"""BLIP-2 checkpoint -> the Blip2T5 tree (port of
``situation3d_tpu/ckpt_compat/blip2.py``).

Maps the reference training checkpoint (``pretrain_blip2_sam_flant5xl_v2.pth``;
the trainable-only save of ``runner_base.py:530-554``) into the tree of
``models/blip2_t5.py``: query tokens, Q-Former layers
(``Qformer.bert.encoder.layer.N.*``), ``t5_proj`` and, when present, the T5
input/output embeddings. The frozen T5 comes from the HF checkpoint through
``ckpt_compat/t5.py``. ``ckpt_compat/from_jax.py:load_jax_variables(...,
partial=True)`` lays a converted tree over a port ``Blip2T5``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from situation3d_tpu_torch.ckpt_compat.common import dense, layernorm
from situation3d_tpu_torch.ckpt_compat.t5 import _resize_rows


def convert_qformer(sd: Dict[str, np.ndarray], num_layers: int = 12,
                    cross_attention_freq: int = 2) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "query_tokens": sd["query_tokens"],
        "emb_norm": layernorm(sd, "Qformer.bert.embeddings.LayerNorm"),
    }

    def attn_block(base):
        return {
            "query": dense(sd, f"{base}.self.query"),
            "key": dense(sd, f"{base}.self.key"),
            "value": dense(sd, f"{base}.self.value"),
            "out_dense": dense(sd, f"{base}.output.dense"),
            "out_norm": layernorm(sd, f"{base}.output.LayerNorm"),
        }

    for i in range(num_layers):
        base = f"Qformer.bert.encoder.layer.{i}"
        layer: Dict[str, Any] = {"attention": attn_block(f"{base}.attention")}
        if i % cross_attention_freq == 0:
            layer["crossattention"] = attn_block(f"{base}.crossattention")
        layer["intermediate_query"] = dense(sd, f"{base}.intermediate_query.dense")
        layer["output_query"] = dense(sd, f"{base}.output_query.dense")
        layer["output_query_norm"] = layernorm(sd, f"{base}.output_query.LayerNorm")
        p[f"layer{i}"] = layer
    return p


def convert_blip2(sd: Dict[str, np.ndarray], num_layers: int = 12,
                  cross_attention_freq: int = 2,
                  vocab_size: Optional[int] = None) -> Dict[str, Any]:
    """Returns a partial Blip2T5 params tree (merge over HF T5 weights)."""
    p: Dict[str, Any] = {
        "qformer": convert_qformer(sd, num_layers, cross_attention_freq),
        "t5_proj": dense(sd, "t5_proj"),
    }
    t5: Dict[str, Any] = {}
    if "t5_model.shared.weight" in sd and vocab_size:
        t5["shared"] = {"embedding": _resize_rows(
            sd["t5_model.shared.weight"], vocab_size, None)}
    if "t5_model.lm_head.weight" in sd and vocab_size:
        t5["lm_head"] = {"kernel": _resize_rows(
            sd["t5_model.lm_head.weight"], vocab_size, None).T}
    if t5:
        p["t5"] = t5
    return p


def merge_params(base: Dict[str, Any], update: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``update`` into a copy of ``base`` (leaf-wise override)."""
    out = dict(base)
    for k, v in update.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_params(out[k], v)
        else:
            out[k] = v
    return out

