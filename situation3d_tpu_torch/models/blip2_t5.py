"""Blip2T5, the 3D-LLM's generative QA model (port of
``situation3d_tpu/models/blip2_t5.py``).

Precomputed scene features [N, 1408] plus 0.01 x a sinusoidal voxel position
encoding -> Q-Former (32 query tokens, cross-attention into the scene) ->
linear ``t5_proj`` to the T5 width -> FlanT5 encoder over ``[query ;
prompt tokens]`` -> cross-entropy on the answer tokens (training) or a
decoder (``predict_answers``: greedy; ``generate``: beam search or nucleus
sampling).

The model is built on its device: modules are made on ``meta``, materialised
where they run and filled from a ``torch.Generator`` on that device
(``models/layers.py:init_blip2_weights``), so the 3B parameters of the default width never
pass through host memory. Parameters are float32; compute runs in ``dtype``.
Freezing (T5 frozen but its embeddings) is the optimizer's mask
(``train/optim.py:blip2_trainable_mask``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from situation3d_tpu_torch.config import Blip2Config
from situation3d_tpu_torch.device import tree_to_device
from situation3d_tpu_torch.models.layers import Dense, materialise
from situation3d_tpu_torch.models.positional import (voxel_position_embedding,
                                                     voxel_position_table)
from situation3d_tpu_torch.models.qformer import QFormer
from situation3d_tpu_torch.models.t5 import (T5ForConditionalGeneration,
                                             beam_search_decode, greedy_decode,
                                             sample_decode, shift_right,
                                             t5_cross_entropy)
from situation3d_tpu_torch.utils.registry import registry
from situation3d_tpu_torch.utils.trace import BATCH, spanned

_MODEL_KEYS = ("pc_feat", "pc", "pc_mask", "input_ids", "input_mask",
               "labels", "label_mask")


@registry.register_model("blip2_t5")
class Blip2T5(nn.Module):
    def __init__(self, cfg: Blip2Config, dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        with torch.device("meta"):
            self.qformer = QFormer(cfg.qformer, dtype)
            self.t5 = T5ForConditionalGeneration(cfg.t5, dtype)
            self.t5_proj = Dense(cfg.qformer.hidden_size, cfg.t5.d_model, dtype)
        materialise(self, device, seed)
        self.register_buffer("pos_table", torch.from_numpy(
            voxel_position_table(cfg.pc_feat_dim // 3)).to(self.device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.t5_proj.weight.device

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return tree_to_device({k: v for k, v in batch.items() if k in _MODEL_KEYS},
                              self.device)

    @spanned("blip2.qformer")
    def encode_scene(self, pc_feat, pc, pc_mask) -> torch.Tensor:
        """Scene features + position encoding -> the query embeddings in T5
        space ([B, num_query_tokens, d_model])."""
        cfg = self.cfg
        pos = voxel_position_embedding(pc, cfg.pc_feat_dim, self.pos_table)
        pc_embeds = pc_feat.to(self.dtype) + cfg.pos_scale * pos.to(self.dtype)
        return self.t5_proj(self.qformer(pc_embeds, pc_mask))

    def _encoder_inputs(self, query_t5, input_ids, input_mask):
        tok = self.t5.embed(input_ids)
        inputs_embeds = torch.cat([query_t5, tok], dim=1)
        q_atts = torch.ones(query_t5.shape[:2], dtype=input_mask.dtype,
                            device=input_mask.device)
        return inputs_embeds, torch.cat([q_atts, input_mask], dim=1)

    def prepare(self, batch: Dict[str, Any]):
        """(inputs_embeds, enc_mask) of a batch: scene queries + prompt."""
        b = self._to_device(batch)
        query_t5 = self.encode_scene(b["pc_feat"], b["pc"], b["pc_mask"])
        return self._encoder_inputs(query_t5, b["input_ids"], b["input_mask"])

    def forward(self, batch: Dict[str, Any], axis: Optional[str] = None
                ) -> Dict[str, torch.Tensor]:
        """Training forward -> {"loss", "logits"}.

        batch: pc_feat [B,N,1408], pc int [B,N,3], pc_mask [B,N],
        input_ids/input_mask [B,Lt] prompt tokens, labels [B,La] answer
        tokens (pad = -100), label_mask [B,La]. ``axis``: this process holds
        its rows of a batch split over processes, and the loss is its term
        of the global batch's token mean (``models/t5.py:t5_cross_entropy``).
        """
        t5c = self.cfg.t5
        b = self._to_device(batch)
        inputs_embeds, enc_mask = self.prepare(b)
        labels = b["labels"].long()
        dec_in = shift_right(labels, t5c.decoder_start_token_id, t5c.pad_token_id)
        logits = self.t5(inputs_embeds, enc_mask, dec_in, b["label_mask"])
        return {"loss": t5_cross_entropy(logits, labels, b["label_mask"], axis),
                "logits": logits}


@torch.no_grad()
@spanned("blip2.predict", request=BATCH)
def predict_answers(model: Blip2T5, batch: Dict[str, Any],
                    max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy generation (beam 1). Returns int64 [B, max_len] token ids."""
    t5c = model.cfg.t5
    inputs_embeds, enc_mask = model.prepare(batch)
    return greedy_decode(model.t5, inputs_embeds, enc_mask, max_len or t5c.max_answer_len,
                         t5c.decoder_start_token_id, t5c.eos_token_id, t5c.pad_token_id)


@torch.no_grad()
def generate(model: Blip2T5, batch: Dict[str, Any], use_nucleus_sampling: bool = False,
             num_beams: int = 5, max_length: int = 30, min_length: int = 1,
             top_p: float = 0.9, repetition_penalty: float = 1.0,
             length_penalty: float = 1.0, temperature: float = 1.0,
             generator: Optional[torch.Generator] = None,
             gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Blip2T5.generate``: beam search (``num_beams`` 5 and
    ``length_penalty`` 1.0 by default) or nucleus sampling
    (``use_nucleus_sampling``: top_p / temperature / repetition_penalty, its
    noise from ``gumbel`` or ``generator``). ``num_beams=1`` without
    sampling is the greedy decoder. Returns int64 [B, max_length]."""
    t5c = model.cfg.t5
    if not use_nucleus_sampling and num_beams == 1:
        return predict_answers(model, batch, max_length)
    inputs_embeds, enc_mask = model.prepare(batch)
    ids = (t5c.decoder_start_token_id, t5c.eos_token_id, t5c.pad_token_id)
    if use_nucleus_sampling:
        return sample_decode(model.t5, inputs_embeds, enc_mask, max_length, *ids,
                             generator=generator, top_p=top_p, temperature=temperature,
                             min_length=min_length,
                             repetition_penalty=repetition_penalty, gumbel=gumbel)
    return beam_search_decode(model.t5, inputs_embeds, enc_mask, max_length, *ids,
                              num_beams=num_beams, length_penalty=length_penalty,
                              min_length=min_length)
