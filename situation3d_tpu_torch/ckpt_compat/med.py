"""HF / BLIP BERT checkpoints -> the MED trees (port of
``situation3d_tpu/ckpt_compat/med.py``).

The state-dict layout of HF ``BertModel`` / ``BertLMHeadModel`` and of the
BLIP MED, which keeps HF's module names (``bert.embeddings.*``,
``bert.encoder.layer.N.{attention,crossattention,intermediate,output}``,
``cls.predictions.*``), into the trees of ``models/med.py``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from situation3d_tpu_torch.ckpt_compat.common import dense, layernorm


def _attn(sd: Dict[str, np.ndarray], base: str) -> Dict[str, Any]:
    return {
        "query": dense(sd, f"{base}.self.query"),
        "key": dense(sd, f"{base}.self.key"),
        "value": dense(sd, f"{base}.self.value"),
        "out_dense": dense(sd, f"{base}.output.dense"),
        "out_norm": layernorm(sd, f"{base}.output.LayerNorm"),
    }


def convert_med_bert(sd: Dict[str, np.ndarray], num_layers: int = 12,
                     prefix: str = "bert") -> Dict[str, Any]:
    """``bert.*`` of a BertModel / BertLMHeadModel state dict -> the
    ``MedBertModel`` tree; ``prefix=""`` reads a bare ``BertModel``."""
    pre = f"{prefix}." if prefix else ""
    p: Dict[str, Any] = {
        "word_embeddings": {"embedding": sd[f"{pre}embeddings.word_embeddings.weight"]},
        "position_embeddings": sd[f"{pre}embeddings.position_embeddings.weight"],
        "emb_norm": layernorm(sd, f"{pre}embeddings.LayerNorm"),
    }
    tt = f"{pre}embeddings.token_type_embeddings.weight"
    if tt in sd:
        p["token_type_embeddings"] = {"embedding": sd[tt]}
    for i in range(num_layers):
        base = f"{pre}encoder.layer.{i}"
        layer: Dict[str, Any] = {"attention": _attn(sd, f"{base}.attention")}
        if f"{base}.crossattention.self.query.weight" in sd:
            layer["crossattention"] = _attn(sd, f"{base}.crossattention")
        layer["intermediate"] = dense(sd, f"{base}.intermediate.dense")
        layer["output"] = dense(sd, f"{base}.output.dense")
        layer["output_norm"] = layernorm(sd, f"{base}.output.LayerNorm")
        p[f"layer{i}"] = layer
    if f"{pre}pooler.dense.weight" in sd:
        p["pooler"] = dense(sd, f"{pre}pooler.dense")
    return p


def convert_med_lm(sd: Dict[str, np.ndarray], num_layers: int = 12) -> Dict[str, Any]:
    """BertLMHeadModel state dict -> the ``MedBertLMHeadModel`` tree: the LM
    head's transform and its untied ``decoder``, whose bias HF stores at
    ``cls.predictions.bias`` and ``...decoder.bias``."""
    head = {
        "transform": dense(sd, "cls.predictions.transform.dense"),
        "transform_norm": layernorm(sd, "cls.predictions.transform.LayerNorm"),
        "decoder": {
            "kernel": sd["cls.predictions.decoder.weight"].T,
            "bias": sd.get("cls.predictions.decoder.bias", sd["cls.predictions.bias"]),
        },
    }
    return {"bert": convert_med_bert(sd, num_layers), "cls": head}
