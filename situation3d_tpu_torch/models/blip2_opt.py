"""Blip2OPT, the OPT-flavoured BLIP-2 3D model (port of
``situation3d_tpu/models/blip2_opt.py``).

The slim query-only Q-Former of ``Blip2T5`` over the scene, projected by
``opt_proj`` into a frozen OPT causal LM that reads the query embeddings as a
prefix before the prompt tokens. The reference's quirks are kept:

- the voxel position encodings are EXTRA tokens after the feature tokens
  (the scene sequence doubles to 2N), unlike ``Blip2T5``'s additive 0.01x;
  their last channel (1407 of 1408) is zero;
- the training loss is the causal-LM cross-entropy over [query prefix ;
  prompt + answer tokens] with the prefix and the prompt positions masked
  (``target_mask`` marks the answer);
- generation stops at the newline token, not ``</s>``: pass the tokenizer's
  newline id as ``eos_id`` to ``opt_predict_answers``.

OPT is frozen in the reference by the optimizer's mask, as T5 is. The model
is built on its device from a seed, as ``Blip2T5`` is.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from situation3d_tpu_torch.config import QFormerConfig
from situation3d_tpu_torch.device import tree_to_device
from situation3d_tpu_torch.models.layers import Dense, materialise
from situation3d_tpu_torch.models.opt import (OPTConfig, OPTForCausalLM,
                                              opt_causal_lm_loss, opt_greedy_decode)
from situation3d_tpu_torch.models.positional import (voxel_position_embedding,
                                                     voxel_position_table)
from situation3d_tpu_torch.models.qformer import QFormer
from situation3d_tpu_torch.utils.registry import registry

_MODEL_KEYS = ("pc_feat", "pc", "pc_mask", "input_ids", "input_mask", "target_mask")


@registry.register_model("blip2_opt")
class Blip2OPT(nn.Module):
    def __init__(self, qformer_cfg: QFormerConfig, opt_cfg: OPTConfig,
                 pc_feat_dim: int = 1408, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.qformer_cfg, self.opt_cfg = qformer_cfg, opt_cfg
        self.pc_feat_dim, self.dtype = pc_feat_dim, dtype
        with torch.device("meta"):
            self.qformer = QFormer(qformer_cfg, dtype)
            self.opt = OPTForCausalLM(opt_cfg, dtype, device="meta")
            self.opt_proj = Dense(qformer_cfg.hidden_size, opt_cfg.hidden_size, dtype)
        materialise(self, device, seed)
        self.register_buffer("pos_table", torch.from_numpy(
            voxel_position_table(pc_feat_dim // 3)).to(self.device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.opt_proj.weight.device

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return tree_to_device({k: v for k, v in batch.items() if k in _MODEL_KEYS},
                              self.device)

    def encode_scene(self, pc_feat, pc, pc_mask) -> torch.Tensor:
        """[features ; position tokens] -> the query embeddings in OPT space
        ([B, num_query_tokens, hidden])."""
        pos = voxel_position_embedding(pc, self.pc_feat_dim, self.pos_table)
        seq = torch.cat([pc_feat.to(self.dtype), pos.to(self.dtype)], dim=1)
        return self.opt_proj(self.qformer(seq, torch.cat([pc_mask, pc_mask], dim=1)))

    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Training forward -> {"loss", "logits"}.

        batch: pc_feat [B,N,1408], pc [B,N,3], pc_mask [B,N], input_ids /
        input_mask [B,L] the tokenized prompt + answer + newline,
        target_mask [B,L] the answer positions (default: input_mask).
        """
        b = self._to_device(batch)
        prefix = self.encode_scene(b["pc_feat"], b["pc"], b["pc_mask"])
        logits = self.opt(b["input_ids"].long(), b["input_mask"], prefix_embeds=prefix)
        tmask = b.get("target_mask", b["input_mask"])
        targets = torch.where(tmask.bool(), b["input_ids"].long(), -100)
        targets = torch.cat([torch.full((targets.shape[0], prefix.shape[1]), -100,
                                        dtype=targets.dtype, device=targets.device),
                             targets], dim=1)
        return {"loss": opt_causal_lm_loss(logits, targets), "logits": logits}


@torch.no_grad()
def opt_predict_answers(model: Blip2OPT, batch: Dict[str, Any], max_len: int = 30,
                        eos_id: Optional[int] = None) -> torch.Tensor:
    """Greedy generation (beam 1) after the scene prefix and the
    (left-padded) prompt ``input_ids`` / ``input_mask``. ``eos_id``: the
    tokenizer's newline id, where the reference stops (default: the
    config's ``eos_token_id``). Returns int64 [B, max_len]."""
    b = model._to_device(batch)
    prefix = model.encode_scene(b["pc_feat"], b["pc"], b["pc_mask"])
    cfg = model.opt_cfg
    return opt_greedy_decode(model.opt, prefix, b["input_ids"], max_len,
                             eos_id=cfg.eos_token_id if eos_id is None else eos_id,
                             pad_id=cfg.pad_token_id, first_mask=b.get("input_mask"))
