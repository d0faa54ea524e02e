"""HF MPNet checkpoint -> the MPNetEncoder tree (port of
``situation3d_tpu/ckpt_compat/mpnet.py``).

Maps ``sentence-transformers/all-mpnet-base-v2`` state-dict names
(``mpnet.``, ``bert_model.``, ``0.auto_model.`` or bare ``embeddings.`` /
``encoder.`` prefixes) into the tree of ``models/lang.py:MPNetEncoder``
(SIG3D's ``lang_net.encoder``), for ``ckpt_compat/from_jax.py``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from situation3d_tpu_torch.ckpt_compat.common import dense, layernorm, strip_prefix


def convert_mpnet(sd: Dict[str, np.ndarray], num_layers: int = 12
                  ) -> Dict[str, Any]:
    for pref in ("mpnet.", "bert_model.", "0.auto_model."):
        if any(k.startswith(pref) for k in sd):
            sd = strip_prefix(sd, pref)
            break
    p: Dict[str, Any] = {
        "word_embeddings": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd["embeddings.position_embeddings.weight"]},
        "emb_norm": layernorm(sd, "embeddings.LayerNorm"),
        "relative_attention_bias": {
            "embedding": sd["encoder.relative_attention_bias.weight"]},
    }
    for i in range(num_layers):
        base = f"encoder.layer.{i}"
        p[f"layer{i}"] = {
            "attention": {
                "q": dense(sd, f"{base}.attention.attn.q"),
                "k": dense(sd, f"{base}.attention.attn.k"),
                "v": dense(sd, f"{base}.attention.attn.v"),
                "o": dense(sd, f"{base}.attention.attn.o"),
            },
            "attention_norm": layernorm(sd, f"{base}.attention.LayerNorm"),
            "intermediate": dense(sd, f"{base}.intermediate.dense"),
            "output": dense(sd, f"{base}.output.dense"),
            "output_norm": layernorm(sd, f"{base}.output.LayerNorm"),
        }
    return p
