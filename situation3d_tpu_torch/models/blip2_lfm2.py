"""The 3D-LLM's scene path in front of a decoder-only language model:
:class:`Blip2Decoder`, and :class:`Blip2LFM2` with an LFM2-MoE
(``models/lfm2.py``); ``models/blip2_nemotron_h.py`` puts Nemotron-H there.

The scene side is ``Blip2T5``'s: precomputed scene features plus 0.01 x the
sinusoidal voxel position encoding, the Q-Former's 32 queries, and a linear
projection (``lfm2_proj``) to the LM's width. The queries are a prefix: each
row is ``[queries ; prompt tokens]``, left-padded as one block, and
:func:`predict_answers` decodes greedily after it. The LM gives the loop its
interface: ``embed``, ``init_cache``, ``prefill``, ``decode_step`` and
``span``, the name its spans take.

Parameters: the LM's in ``param_dtype`` (its router in float32), the
Q-Former's and the projection's in float32; products in ``dtype``. The model
is built on its device from a seed, as ``Blip2T5`` is.

Greedy decoding runs ``models/step_graphs.py``'s loop: on a CUDA device with
grad off it captures each decode step once per key (batch, prefix slots,
length, end and pad ids) as a CUDA graph over static buffers (the hybrid
cache and the tokens) and replays it; the prefill runs eagerly into those
buffers. On the CPU or with grad on the same step function runs eagerly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from situation3d_tpu_torch.config import QFormerConfig
from situation3d_tpu_torch.device import tree_to_device
from situation3d_tpu_torch.models.layers import Dense, materialise
from situation3d_tpu_torch.models.lfm2 import DecodeState, LFM2Config, Lfm2ForCausalLM
from situation3d_tpu_torch.models.positional import (voxel_position_embedding,
                                                     voxel_position_table)
from situation3d_tpu_torch.models.qformer import QFormer
from situation3d_tpu_torch.models.step_graphs import (GraphCache, GreedyTokens, capture_steps,
                                                     eager, greedy_loop)
from situation3d_tpu_torch.utils.registry import registry
from situation3d_tpu_torch.utils.trace import BATCH, span, spanned

_MODEL_KEYS = ("pc_feat", "pc", "pc_mask")

decode_graph_captures = 0   # +1 per greedy step graph captured, nowhere else
decode_graph_replays = 0    # +1 per greedy step graph replayed, nowhere else


class Blip2Decoder(nn.Module):
    """The scene side before a decoder-only LM, held as ``lm_name`` (built by
    ``make_lm(lm_cfg, dtype, param_dtype)``) and its projection as
    ``proj_name``."""

    lm_name, proj_name = "lm", "lm_proj"

    def __init__(self, qformer_cfg: QFormerConfig, lm_cfg, pc_feat_dim: int = 1408,
                 pos_scale: float = 0.01, max_txt_len: int = 400,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.qformer_cfg, self.lm_cfg = qformer_cfg, lm_cfg
        self.pc_feat_dim, self.pos_scale, self.dtype = pc_feat_dim, pos_scale, dtype
        self.max_txt_len = max_txt_len
        with torch.device("meta"):
            self.qformer = QFormer(qformer_cfg, dtype)
            setattr(self, self.lm_name, self.make_lm(lm_cfg, dtype, param_dtype))
            setattr(self, self.proj_name,
                    Dense(qformer_cfg.hidden_size, lm_cfg.hidden_size, dtype))
        materialise(self, device, seed)
        self.register_buffer("pos_table", torch.from_numpy(
            voxel_position_table(pc_feat_dim // 3)).to(self.device), persistent=False)
        self.decode_graphs = DecodeGraphs()

    @staticmethod
    def make_lm(cfg, dtype: torch.dtype, param_dtype: torch.dtype) -> nn.Module:
        raise NotImplementedError

    @property
    def lm(self) -> nn.Module:
        return getattr(self, self.lm_name)

    @property
    def proj(self) -> Dense:
        return getattr(self, self.proj_name)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    @property
    def prefix_slots(self) -> int:
        """KV positions a row holds before its answer: the queries and the
        longest prompt."""
        return self.qformer_cfg.num_query_tokens + self.max_txt_len

    @spanned("blip2.qformer")
    def encode_scene(self, pc_feat, pc, pc_mask) -> torch.Tensor:
        """Scene features + position encoding -> the query embeddings in the
        LM's space ([B, num_query_tokens, hidden])."""
        pos = voxel_position_embedding(pc, self.pc_feat_dim, self.pos_table)
        pc_embeds = pc_feat.to(self.dtype) + self.pos_scale * pos.to(self.dtype)
        return self.proj(self.qformer(pc_embeds, pc_mask))

    def prefix(self, batch: Dict[str, Any]):
        """(inputs_embeds, mask) [B, L, D] / [B, L]: each row's [queries ;
        prompt tokens], left-padded as one block to the batch's longest.
        ``input_ids`` / ``input_mask`` are right-padded prompts; their lengths
        are read on the host before anything runs on the device."""
        ids = np.asarray(torch.as_tensor(batch["input_ids"]).cpu())
        lens = np.asarray(torch.as_tensor(batch["input_mask"]).cpu()).astype(bool).sum(1)
        nq, B = self.qformer_cfg.num_query_tokens, ids.shape[0]
        if int(lens.max()) > self.max_txt_len:
            raise ValueError(f"a prompt of {int(lens.max())} tokens; at most {self.max_txt_len}")
        width = int(lens.max())
        L = nq + width
        pad = L - nq - lens                                    # [B]
        j = np.arange(L)[None]
        src = np.where(j >= pad[:, None], j - pad[:, None], 0)
        dev = self.device
        b = tree_to_device({k: v for k, v in batch.items() if k in _MODEL_KEYS}, dev)
        query = self.encode_scene(b["pc_feat"], b["pc"], b["pc_mask"])
        tok = self.lm.embed(torch.as_tensor(ids[:, :width]).to(dev, torch.long))
        both = torch.cat([query.to(tok.dtype), tok], 1)
        index = torch.as_tensor(src).to(dev)[..., None].expand(B, L, both.shape[-1])
        mask = torch.as_tensor(j >= pad[:, None]).to(dev)
        return torch.gather(both, 1, index), mask


@registry.register_model("blip2_lfm2")
class Blip2LFM2(Blip2Decoder):
    lm_name, proj_name = "lfm2", "lfm2_proj"

    @staticmethod
    def make_lm(cfg: LFM2Config, dtype: torch.dtype, param_dtype: torch.dtype
                ) -> Lfm2ForCausalLM:
        return Lfm2ForCausalLM(cfg, dtype, param_dtype)


class GreedyBuffers(GreedyTokens):
    """The static state of one greedy decode key: the LM's decode state and
    the tokens (:class:`GreedyTokens`)."""

    def __init__(self, lm: nn.Module, batch: int, prefix_slots: int, max_len: int,
                 device):
        super().__init__(batch, max_len, device)
        self.cache: DecodeState = lm.init_cache(batch, prefix_slots, max(max_len - 1, 1), device)


def greedy_step(lm: nn.Module, b: GreedyBuffers, i: int, eos_id: int, pad_id: int,
                check: bool) -> torch.Tensor:
    """Greedy token ``i`` (1 onwards): decode step ``i - 1`` on ``b``'s
    cache, fed the last token. Returns the step's logits."""
    logits = lm.decode_step(b.tok, b.cache, i - 1)
    b.emit(i, logits, eos_id, pad_id, check)
    return logits


class CapturedDecode:
    """One key's buffers and its step graphs (tokens 1 .. max_len - 1) in one
    memory pool; ``logits[i - 1]``: token ``i``'s step output in that pool."""

    def __init__(self, lm: nn.Module, batch: int, prefix_slots: int, max_len: int,
                 eos_id: int, pad_id: int, device):
        global decode_graph_captures
        self.buffers = b = GreedyBuffers(lm, batch, prefix_slots, max_len, device)
        b.reset(pad_id, pad_id)
        self.graphs, self.logits = capture_steps(
            lambda i, check: greedy_step(lm, b, i, eos_id, pad_id, check),
            range(1, max_len), device)
        decode_graph_captures += len(self.graphs)

    def replay(self, i: int) -> None:
        global decode_graph_replays
        self.graphs[i - 1].replay()
        decode_graph_replays += 1


class DecodeGraphs(GraphCache):
    """A model's captured greedy decodes (``models/step_graphs.py``), keyed
    ``(B, prefix slots, max_len, eos, pad, device, inference mode)`` and
    dropped when the LM's parameter storage moved."""

    def get(self, lm: nn.Module, batch: int, prefix_slots: int, max_len: int,
            eos_id: int, pad_id: int, device) -> Optional[CapturedDecode]:
        """This call's captured decode; None where the steps run eagerly
        (``step_graphs.eager``) or there is no step (a single token)."""
        if eager(device) or max_len < 2:
            return None
        key = (batch, prefix_slots, max_len, eos_id, pad_id, device,
               torch.is_inference_mode_enabled())
        return self.lookup(key, (lm,), lambda: CapturedDecode(
            lm, batch, prefix_slots, max_len, eos_id, pad_id, device))


@torch.no_grad()
@spanned("blip2.predict", request=BATCH)
def predict_answers(model: Blip2Decoder, batch: Dict[str, Any], max_len: int = 10,
                    eos_id: Optional[int] = None, graphs: bool = True) -> torch.Tensor:
    """Greedy generation (beam 1) after each row's scene queries and prompt
    (``input_ids`` / ``input_mask``, right-padded). Returns int64 [B,
    max_len], pad after a row's end token; stops once every row has ended.
    ``graphs=False`` runs every step eagerly, as on the CPU. The spans are
    ``<lm.span>.prefill`` and ``<lm.span>.decode_step``."""
    cfg, lm = model.lm_cfg, model.lm
    eos, pad = (cfg.eos_token_id if eos_id is None else eos_id), cfg.pad_token_id
    embeds, mask = model.prefix(batch)
    B, dev = embeds.shape[0], embeds.device
    captured = (model.decode_graphs.get(lm, B, model.prefix_slots, max_len, eos, pad, dev)
                if graphs else None)
    b = captured.buffers if captured else GreedyBuffers(lm, B, model.prefix_slots, max_len, dev)
    b.reset(pad, pad)
    # the prefill's span holds token 0 and the check that ends the loop after it
    with span(f"{lm.span}.prefill"):
        b.emit(0, lm.prefill(embeds, mask, b.cache), eos, pad, max_len > 1)
        last = max_len if max_len > 1 and not bool(b.finished) else 1
    return greedy_loop(b, range(1, last), lambda i, check: greedy_step(lm, b, i, eos, pad, check),
                       captured.replay if captured else None, f"{lm.span}.decode_step")


lfm2_predict_answers = predict_answers      # the name LFM2's callers know
