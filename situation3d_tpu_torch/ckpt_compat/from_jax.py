"""Carry the reference's weights into the port.

``load_jax_variables(model, params, batch_stats)`` takes the reference
model's ``params`` and ``batch_stats`` trees as nested dicts of NUMPY arrays
(this module imports no JAX) and fills the port's ``SIG3D``. The port's
module paths equal the reference's tree paths, so the mapping is by module
type:

  Dense          kernel [in, out] -> weight [out, in]; bias
  Embed          embedding -> weight
  LayerNorm      scale -> weight; bias
  MCANLayerNorm  scale; bias
  SparseConv / SparseConv1x1   kernel, layout kept
  SparseBatchNorm  params scale, bias; batch_stats mean, var
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from situation3d_tpu_torch.models.layers import Dense, Embed, LayerNorm
from situation3d_tpu_torch.models.mcan import MCANLayerNorm
from situation3d_tpu_torch.sparse.conv import (SparseBatchNorm, SparseConv,
                                               SparseConv1x1)

# module type -> [(port tensor name, reference collection, reference leaf, transpose)]
_RULES = {
    Dense: [("weight", "params", "kernel", True), ("bias", "params", "bias", False)],
    Embed: [("weight", "params", "embedding", False)],
    LayerNorm: [("weight", "params", "scale", False), ("bias", "params", "bias", False)],
    MCANLayerNorm: [("scale", "params", "scale", False), ("bias", "params", "bias", False)],
    SparseConv: [("kernel", "params", "kernel", False)],
    SparseConv1x1: [("kernel", "params", "kernel", False)],
    SparseBatchNorm: [("scale", "params", "scale", False), ("bias", "params", "bias", False),
                      ("mean", "batch_stats", "mean", False),
                      ("var", "batch_stats", "var", False)],
}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def load_jax_variables(model: torch.nn.Module, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> List[str]:
    """Fill ``model`` from the reference's variable trees.

    Raises ``KeyError`` on a reference leaf the port needs and cannot find,
    ``ValueError`` on a shape mismatch, and ``RuntimeError`` if a port
    parameter or buffer stays unfilled. Returns the sorted list of reference
    leaves it did not use (``"params/scene_encoder/block5/..."``: the
    decoder the port does not have), so nothing is dropped silently.
    """
    trees = {"params": params, "batch_stats": batch_stats}
    used = set()
    filled = set()
    state: Dict[str, torch.Tensor] = dict(model.state_dict(keep_vars=True))
    for mod_name, mod in model.named_modules():
        rules = _RULES.get(type(mod))
        if rules is None:
            continue
        path = tuple(mod_name.split(".")) if mod_name else ()
        for tensor_name, coll, leaf, transpose in rules:
            node: Any = trees[coll]
            for key in path + (leaf,):
                if not isinstance(node, Mapping) or key not in node:
                    raise KeyError(f"reference leaf {coll}/{'/'.join(path + (leaf,))} "
                                   f"is missing (needed by {mod_name}.{tensor_name})")
                node = node[key]
            value = np.array(node, dtype=np.float32)       # a writable copy
            if transpose:
                value = np.ascontiguousarray(value.T)
            target = state[f"{mod_name}.{tensor_name}" if mod_name else tensor_name]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {mod_name}.{tensor_name}: reference "
                    f"{tuple(value.shape)} vs port {tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.from_numpy(value))
            used.add((coll,) + path + (leaf,))
            filled.add(f"{mod_name}.{tensor_name}" if mod_name else tensor_name)
    unfilled = sorted(set(state) - filled)
    if unfilled:
        raise RuntimeError(f"port tensors left unfilled: {unfilled}")
    unused = [p for coll, tree in trees.items()
              for p in _leaves(tree, (coll,)) if p not in used]
    return sorted("/".join(p) for p in unused)
