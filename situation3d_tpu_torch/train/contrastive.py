"""BLIP-2 stage-1 pretraining losses, ITC / ITM / LM (port of
``situation3d_tpu/train/contrastive.py``).

Pure functions on tensors, so any encoder pair (the Q-Former's query
features against its text features) can feed them. ``axis`` names the data
axis of a run of several processes, each holding its rows of the global
batch (``parallel/mesh.py``): the contrastive loss then takes its negatives
from every process's rows (a differentiable ``all_gather``), and the LM loss
divides by the global batch's token count, so that the processes' mean loss
and gradient are the global batch's. ``axis=None``: this process's batch
alone.
"""
from __future__ import annotations

from typing import Optional

import torch

from situation3d_tpu_torch.parallel import collectives


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
    """Image-text contrastive loss with in-batch negatives, and with
    ``axis`` those of every process (targets offset by ``rank * B``).

    image_feats [B, Q, D] (per-query features: the similarity is the max over
    queries) or [B, D]; text_feats [B, D]; ``temperature`` a scalar.
    """
    if image_feats.dim() == 2:
        image_feats = image_feats[:, None, :]
    image_feats = normalize(image_feats)
    text_feats = normalize(text_feats)
    B = text_feats.shape[0]
    if axis is not None:
        all_image = collectives.all_gather(image_feats, tiled=True)
        all_text = collectives.all_gather(text_feats, tiled=True)
        offset = collectives.rank() * B
    else:
        all_image, all_text, offset = image_feats, text_feats, 0
    # sim_i2t[b, j] = max_q <image_b_q, text_j>; sim_t2i[b, j] = max_q <text_b, image_j_q>
    sim_i2t = torch.einsum("bqd,jd->bqj", image_feats, all_text).amax(dim=1)
    sim_t2i = torch.einsum("bd,jqd->bjq", text_feats, all_image).amax(dim=2)
    targets = torch.arange(B, device=text_feats.device) + offset
    loss = (softmax_cross_entropy(sim_i2t / temperature, targets)
            + softmax_cross_entropy(sim_t2i / temperature, targets))
    return loss.mean() / 2


def itm_loss(match_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Image-text matching head's cross-entropy, in float32."""
    return softmax_cross_entropy(match_logits.float(), labels).mean()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
            axis: Optional[str] = None) -> torch.Tensor:
    """Caption LM loss: the token mean of the cross-entropy over ``mask``
    (negative labels read as 0), in float32; with ``axis`` this process's
    term of the global batch's token mean (``collectives.token_mean``)."""
    per = softmax_cross_entropy(logits.float(), labels.clamp(min=0))
    m = mask.float()
    if axis is not None:
        return collectives.token_mean((per * m).sum(), m.sum())
    return (per * m).sum() / m.sum().clamp(min=1.0)
