"""BLIP-2 stage-1 pretraining losses, ITC / ITM / LM (port of
``situation3d_tpu/train/contrastive.py``).

Pure functions on tensors, so any encoder pair (the Q-Former's query
features against its text features) can feed them. The image-text
contrastive loss takes its negatives from the batch on this device
(``axis=None``); negatives gathered across devices (the reference's
``all_gather`` over a mesh axis) come with multi-GPU data parallelism,
Slice D3 of the port, and ``axis`` raises until then.
"""
from __future__ import annotations

from typing import Optional

import torch


def normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / max(|x|, 1e-12)`` over the last axis."""
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row ``logsumexp(logits) - logits[label]`` (optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    picked = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - picked


def itc_loss(image_feats: torch.Tensor, text_feats: torch.Tensor,
             temperature: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
    """Image-text contrastive loss with in-batch negatives.

    image_feats [B, Q, D] (per-query features: the similarity is the max over
    queries) or [B, D]; text_feats [B, D]; ``temperature`` a scalar.
    """
    if axis is not None:
        raise NotImplementedError(
            f"itc_loss(axis={axis!r}): negatives gathered across devices come with "
            "multi-GPU data parallelism (Slice D3 of the port); use axis=None")
    if image_feats.dim() == 2:
        image_feats = image_feats[:, None, :]
    image_feats = normalize(image_feats)
    text_feats = normalize(text_feats)
    B = text_feats.shape[0]
    # sim_i2t[b, j] = max_q <image_b_q, text_j>; sim_t2i[b, j] = max_q <text_b, image_j_q>
    sim_i2t = torch.einsum("bqd,jd->bqj", image_feats, text_feats).amax(dim=1)
    sim_t2i = torch.einsum("bd,jqd->bjq", text_feats, image_feats).amax(dim=2)
    targets = torch.arange(B, device=text_feats.device)
    loss = (softmax_cross_entropy(sim_i2t / temperature, targets)
            + softmax_cross_entropy(sim_t2i / temperature, targets))
    return loss.mean() / 2


def itm_loss(match_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Image-text matching head's cross-entropy, in float32."""
    return softmax_cross_entropy(match_logits.float(), labels).mean()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Caption LM loss: the token mean of the cross-entropy over ``mask``
    (negative labels read as 0), in float32."""
    per = softmax_cross_entropy(logits.float(), labels.clamp(min=0))
    m = mask.float()
    return (per * m).sum() / m.sum().clamp(min=1.0)
