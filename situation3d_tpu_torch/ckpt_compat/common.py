"""Reference-format torch checkpoints -> the reference's parameter-tree
layout (port of ``situation3d_tpu/ckpt_compat/common.py``).

The converters of this package return nested dicts of numpy arrays laid out
as the JAX package's flax trees (``Dense.kernel`` [in, out], LayerNorm
``scale``), the names ``ckpt_compat/from_jax.py`` maps onto the port's
modules; ``load_jax_variables(model, tree, {}, partial=True)`` lays such a
tree over a port model. Conventions:

- torch ``Linear.weight`` is ``[out, in]`` -> ``kernel`` ``[in, out]``;
- torch ``LayerNorm.weight`` -> ``scale``;
- embeddings keep their layout.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint into a flat {name: np.ndarray} dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    return {k: np.asarray(v.detach().cpu().numpy()) if hasattr(v, "detach")
            else np.asarray(v) for k, v in obj.items()}


def linear_kernel(sd: Dict[str, np.ndarray], name: str) -> np.ndarray:
    return np.ascontiguousarray(sd[f"{name}.weight"].T)


def dense(sd: Dict[str, np.ndarray], name: str, bias: bool = True) -> Dict[str, Any]:
    out = {"kernel": linear_kernel(sd, name)}
    if bias and f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def layernorm(sd: Dict[str, np.ndarray], name: str) -> Dict[str, Any]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}



def strip_prefix(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The entries under ``prefix``, with the prefix taken off their names."""
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}
