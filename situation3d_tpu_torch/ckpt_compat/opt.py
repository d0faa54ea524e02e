"""HF OPT checkpoint -> the OPT tree (port of
``situation3d_tpu/ckpt_compat/opt.py``).

Maps a ``facebook/opt-*`` ``OPTForCausalLM`` state dict (``model.decoder.*``,
``decoder.*`` or bare) into the tree of ``models/opt.py:OPTForCausalLM``. The
LM head is tied to ``embed_tokens`` on both sides, so only the decoder's
weights carry over. ``ckpt_compat/from_jax.py:load_jax_variables`` lays the
tree over a port model.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from situation3d_tpu_torch.ckpt_compat.common import dense, layernorm


def convert_opt(sd: Dict[str, np.ndarray], num_layers: int) -> Dict[str, Any]:
    pref = "model.decoder."
    if not any(k.startswith(pref) for k in sd):
        pref = "decoder." if any(k.startswith("decoder.") for k in sd) else ""
    p: Dict[str, Any] = {
        "embed_tokens": {"embedding": sd[f"{pref}embed_tokens.weight"]},
        "embed_positions": {"embedding": sd[f"{pref}embed_positions.weight"]},
        "final_norm": layernorm(sd, f"{pref}final_layer_norm"),
    }
    for i in range(num_layers):
        b = f"{pref}layers.{i}"
        p[f"layer{i}"] = {
            "self_attn_layer_norm": layernorm(sd, f"{b}.self_attn_layer_norm"),
            "final_layer_norm": layernorm(sd, f"{b}.final_layer_norm"),
            "self_attn": {name: dense(sd, f"{b}.self_attn.{name}")
                          for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "fc1": dense(sd, f"{b}.fc1"),
            "fc2": dense(sd, f"{b}.fc2"),
        }
    return p
