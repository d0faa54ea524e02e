"""Carry the reference's weights into the port.

``load_jax_variables(model, params, batch_stats)`` takes the reference
model's ``params`` and ``batch_stats`` trees as nested dicts of NUMPY arrays
(this module imports no JAX) and fills a port model (``SIG3D``, ``VoteNet``,
``Blip2T5``, ``Blip2Qformer``, ``Blip2OPT``, ``OPTForCausalLM``, the MED and
ViT models, ``ENetForMultiview``, or any of their parts). The port's module paths equal the
reference's tree paths, so the mapping is by module type:

  Dense          kernel [in, out] -> weight [out, in]; bias (where it has one)
  Embed          embedding -> weight
  LayerNorm      scale -> weight; bias
  T5LayerNorm    weight
  QFormer, QFormerTextModel   query_tokens
  Blip2Qformer, Blip2ITM      temp; lm_bias
  MedBertModel   position_embeddings
  EvaAttention   qkv_kernel, layout kept; q_bias, k_bias, v_bias (where it has them)
  PatchEmbed     kernel (HWIO), layout kept; bias (where it has one)
  EvaViT         cls_token; pos_embed
  ClipViT        class_embedding; positional_embedding
  SharedRelPosBias  table
  MCANLayerNorm  scale; bias
  SparseConv / SparseConv1x1   kernel, layout kept; bias (where it has one)
  SparseBatchNorm, BatchNorm  params scale, bias; batch_stats mean, var
  enet.Conv      kernel (HWIO), layout kept; bias (where it has one)
  enet.PReLU     negative_slope

The GloVe + LSTM encoder's cell keeps the reference's eight ``Dense``
leaves (``ii``/``if``/``ig``/``io`` without bias, ``hi``/``hf``/``hg``/``ho``
with one), so it maps by the ``Dense`` rule.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from situation3d_tpu_torch.models import enet
from situation3d_tpu_torch.models.blip2_qformer import (Blip2ITM, Blip2Qformer,
                                                        QFormerTextModel)
from situation3d_tpu_torch.models.layers import (BatchNorm, Dense, Embed,
                                                  LayerNorm)
from situation3d_tpu_torch.models.mcan import MCANLayerNorm
from situation3d_tpu_torch.models.med import MedBertModel
from situation3d_tpu_torch.models.qformer import QFormer
from situation3d_tpu_torch.models.t5 import T5LayerNorm
from situation3d_tpu_torch.models.vit import (ClipViT, EvaAttention, EvaViT, PatchEmbed,
                                              SharedRelPosBias)
from situation3d_tpu_torch.sparse.conv import (SparseBatchNorm, SparseConv,
                                               SparseConv1x1)

_NORM_RULES = [("scale", "params", "scale", False), ("bias", "params", "bias", False),
               ("mean", "batch_stats", "mean", False),
               ("var", "batch_stats", "var", False)]


def _leaf_rules(*names):
    """Tensors stored on the module itself, under their own names, layout kept."""
    return [(n, "params", n, False) for n in names]


_STAGE1 = _leaf_rules("temp", "lm_bias")
# module type -> [(port tensor name, reference collection, reference leaf, transpose)]
_RULES = {
    Dense: [("weight", "params", "kernel", True), ("bias", "params", "bias", False)],
    Embed: [("weight", "params", "embedding", False)],
    LayerNorm: [("weight", "params", "scale", False), ("bias", "params", "bias", False)],
    MCANLayerNorm: [("scale", "params", "scale", False), ("bias", "params", "bias", False)],
    T5LayerNorm: [("weight", "params", "weight", False)],
    QFormer: _leaf_rules("query_tokens"),
    QFormerTextModel: _leaf_rules("query_tokens"),
    Blip2Qformer: _STAGE1,
    Blip2ITM: _STAGE1,
    MedBertModel: _leaf_rules("position_embeddings"),
    EvaAttention: _leaf_rules("qkv_kernel", "q_bias", "k_bias", "v_bias"),
    PatchEmbed: _leaf_rules("kernel", "bias"),
    EvaViT: _leaf_rules("cls_token", "pos_embed"),
    ClipViT: _leaf_rules("class_embedding", "positional_embedding"),
    SharedRelPosBias: _leaf_rules("table"),
    SparseConv: [("kernel", "params", "kernel", False)],
    SparseConv1x1: [("kernel", "params", "kernel", False), ("bias", "params", "bias", False)],
    SparseBatchNorm: _NORM_RULES,
    BatchNorm: _NORM_RULES,
    enet.Conv: _leaf_rules("kernel", "bias"),
    enet.PReLU: _leaf_rules("negative_slope"),
}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def reference_paths(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """``{port parameter name: (reference tree path, transposed)}`` for every
    parameter of ``model`` the rules map."""
    out = {}
    for mod_name, mod in model.named_modules():
        path = tuple(mod_name.split(".")) if mod_name else ()
        for tensor_name, coll, leaf, transpose in _RULES.get(type(mod), ()):
            if coll == "params" and getattr(mod, tensor_name) is not None:
                out[f"{mod_name}.{tensor_name}" if mod_name else tensor_name] = (
                    path + (leaf,), transpose)
    return out


def load_jax_variables(model: torch.nn.Module, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any], partial: bool = False) -> List[str]:
    """Fill ``model`` from the reference's variable trees.

    Raises ``KeyError`` on a reference leaf the port needs and cannot find,
    ``ValueError`` on a shape mismatch, and ``RuntimeError`` if a port
    parameter or buffer stays unfilled. Returns the sorted list of reference
    leaves it did not use (none for the port's models), so nothing is
    dropped silently. ``partial=True`` lays a partial tree over the model
    (a converted checkpoint that holds some parts): leaves the tree lacks
    keep their values, and shapes are still checked.
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
            if getattr(mod, tensor_name) is None:     # a module built without a bias
                continue
            node: Any = trees[coll]
            for key in path + (leaf,):
                if not isinstance(node, Mapping) or key not in node:
                    if partial:
                        node = None
                        break
                    raise KeyError(f"reference leaf {coll}/{'/'.join(path + (leaf,))} "
                                   f"is missing (needed by {mod_name}.{tensor_name})")
                node = node[key]
            if node is None:          # absent from a partial tree
                continue
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
    if unfilled and not partial:
        raise RuntimeError(f"port tensors left unfilled: {unfilled}")
    unused = [p for coll, tree in trees.items()
              for p in _leaves(tree, (coll,)) if p not in used]
    return sorted("/".join(p) for p in unused)
