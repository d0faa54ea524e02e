"""Plain PyTorch reference of the 3D-LLM's training step (BLIP-2 Q-Former +
FlanT5, T5 frozen but its input and output embeddings): ``reference/
blip2.py``'s forward, the answer's token-mean cross-entropy, autograd, then
clip by value and AdamW (``reference/sig3d.py:AdamW``: the port's 3D-LLM
optimizer clips by value too, and decays the same matrices).

The loss: the decoder teacher-forced over [start ; answer tokens but the
last] (pad where the answer has ended), the cross-entropy of each answer
token, their mean over the batch's answer tokens. Float32, products in
``precision``. Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmarks.reference.blip2 import Blip2Reference


def trainable(name: str) -> bool:
    """The recipe: T5 frozen but ``shared`` and ``lm_head``; the Q-Former and
    ``t5_proj`` trained."""
    return not name.startswith("t5.") or name in ("t5.shared.weight", "t5.lm_head.weight")


def loss(model: Blip2Reference, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    s, w = model.s, model.w
    q = model.queries(batch["pc_feat"], batch["pc"], batch["pc_mask"])
    tok = w["t5.shared.weight"][batch["input_ids"].long()]
    mask = torch.cat([torch.ones(q.shape[:2], device=q.device, dtype=batch["input_mask"].dtype),
                      batch["input_mask"]], 1)
    enc = model.encode(torch.cat([q, tok], 1), mask)
    labels, keep = batch["labels"].long(), batch["label_mask"].bool()
    start = torch.full_like(labels[:, :1], s["t5.decoder_start_token_id"])
    dec_in = torch.cat([start, labels[:, :-1]], 1)
    dec_in = torch.where(dec_in < 0, s["t5.pad_token_id"], dec_in)
    logits = model.decode(enc, mask, dec_in)
    per = F.cross_entropy(logits.flatten(0, 1), labels.clamp(min=0).flatten(),
                          reduction="none").view(labels.shape)
    return (per * keep).sum() / keep.sum()
