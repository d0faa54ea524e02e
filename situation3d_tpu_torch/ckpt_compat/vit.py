"""Torch ViT checkpoints -> the ViT trees (port of
``situation3d_tpu/ckpt_compat/vit.py``).

The vision-encoder state dicts of the reference (EVA's ``eva_vit_g.pth``,
timm ViTs, OpenAI CLIP's visual tower) into the trees of
``models/vit.py:EvaViT`` / ``ClipViT``, with the position embedding resized
for another image size (``models/vit.py:interpolate_pos_embed``). Layouts:

- torch Conv2d OIHW -> HWIO;
- EVA's fused ``attn.qkv.weight`` [3C, C] -> one ``qkv_kernel`` [C, 3C] and
  the ``q_bias`` / ``v_bias`` vectors (the k bias is zero); a timm
  ``attn.qkv.bias`` splits into q / k / v thirds;
- CLIP's ``attn.in_proj_weight`` / ``in_proj_bias`` -> the ``in_proj``
  Dense; ``mlp.c_fc`` / ``mlp.c_proj`` keep their names.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from situation3d_tpu_torch.ckpt_compat.common import dense, layernorm
from situation3d_tpu_torch.models.vit import interpolate_pos_embed


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _maybe_interp(pos: np.ndarray, num_patches: Optional[int]) -> np.ndarray:
    if num_patches is None or pos.shape[1] == num_patches + 1:
        return np.asarray(pos)
    return interpolate_pos_embed(pos, num_patches).numpy()


def _patch_embed(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    return {"kernel": _conv_kernel(sd["patch_embed.proj.weight"]),
            "bias": sd["patch_embed.proj.bias"]}


def convert_eva_vit(sd: Dict[str, np.ndarray], depth: int = 39,
                    num_patches: Optional[int] = None) -> Dict[str, Any]:
    """``eva_vit_g.pth`` state dict -> the ``EvaViT`` tree."""
    p: Dict[str, Any] = {"patch_embed": _patch_embed(sd), "cls_token": sd["cls_token"],
                         "pos_embed": _maybe_interp(sd["pos_embed"], num_patches)}
    for i in range(depth):
        b = f"blocks.{i}"
        p[f"block{i}"] = {
            "norm1": layernorm(sd, f"{b}.norm1"),
            "norm2": layernorm(sd, f"{b}.norm2"),
            "attn": {"qkv_kernel": np.transpose(sd[f"{b}.attn.qkv.weight"]),
                     "q_bias": sd[f"{b}.attn.q_bias"], "v_bias": sd[f"{b}.attn.v_bias"],
                     "proj": dense(sd, f"{b}.attn.proj")},
            "mlp_fc1": dense(sd, f"{b}.mlp.fc1"),
            "mlp_fc2": dense(sd, f"{b}.mlp.fc2"),
        }
    return p


def convert_timm_vit(sd: Dict[str, np.ndarray], depth: int = 12,
                     num_patches: Optional[int] = None) -> Dict[str, Any]:
    """Plain timm ViT state dict -> the tree of an ``EvaViT`` with
    ``full_qkv_bias`` and ``final_norm``."""
    p: Dict[str, Any] = {"patch_embed": _patch_embed(sd), "cls_token": sd["cls_token"],
                         "pos_embed": _maybe_interp(sd["pos_embed"], num_patches),
                         "norm": layernorm(sd, "norm")}
    for i in range(depth):
        b = f"blocks.{i}"
        qb, kb, vb = np.split(sd[f"{b}.attn.qkv.bias"], 3)
        p[f"block{i}"] = {
            "norm1": layernorm(sd, f"{b}.norm1"),
            "norm2": layernorm(sd, f"{b}.norm2"),
            "attn": {"qkv_kernel": np.transpose(sd[f"{b}.attn.qkv.weight"]),
                     "q_bias": qb, "k_bias": kb, "v_bias": vb,
                     "proj": dense(sd, f"{b}.attn.proj")},
            "mlp_fc1": dense(sd, f"{b}.mlp.fc1"),
            "mlp_fc2": dense(sd, f"{b}.mlp.fc2"),
        }
    return p


def convert_clip_vit(sd: Dict[str, np.ndarray], depth: int = 21,
                     num_patches: Optional[int] = None) -> Dict[str, Any]:
    """OpenAI CLIP visual state dict (``visual.`` prefix or bare) -> the
    ``ClipViT`` tree."""
    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    p: Dict[str, Any] = {
        "conv1": {"kernel": _conv_kernel(sd["conv1.weight"])},
        "class_embedding": sd["class_embedding"],
        "positional_embedding": _maybe_interp(sd["positional_embedding"][None], num_patches)[0],
        "ln_pre": layernorm(sd, "ln_pre"),
    }
    for i in range(depth):
        b = f"transformer.resblocks.{i}"
        p[f"block{i}"] = {
            "ln_1": layernorm(sd, f"{b}.ln_1"),
            "ln_2": layernorm(sd, f"{b}.ln_2"),
            "in_proj": {"kernel": np.transpose(sd[f"{b}.attn.in_proj_weight"]),
                        "bias": sd[f"{b}.attn.in_proj_bias"]},
            "out_proj": dense(sd, f"{b}.attn.out_proj"),
            "c_fc": dense(sd, f"{b}.mlp.c_fc"),
            "c_proj": dense(sd, f"{b}.mlp.c_proj"),
        }
    return p
