"""SIG3D loss composition (port of ``situation3d_tpu/train/losses.py``):
answer loss (BCE-with-logits summed over classes / batch, or CE on the
integer label), the situation position + rotation loss for each tag, the
weights, and the final amplification. The detection terms are zeros, as in
the reference's default."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from situation3d_tpu_torch.config import LossConfig


def answer_classification_loss(
    answer_scores: torch.Tensor,
    answer_cat_scores: Optional[torch.Tensor] = None,
    answer_cat: Optional[torch.Tensor] = None,
    kind: str = "bce",
) -> torch.Tensor:
    """BCE-with-logits summed over classes / batch (multi-answer) or CE on
    the integer answer; ``kind`` (``cfg.loss.answer_loss``) selects."""
    if kind == "bce" and answer_cat_scores is not None:
        per = F.binary_cross_entropy_with_logits(
            answer_scores, answer_cat_scores.to(answer_scores.dtype), reduction="sum")
        return per / answer_scores.shape[0]
    if answer_cat is None:
        raise ValueError(
            f"answer_loss={kind!r} needs 'answer_cat' in the batch "
            "or answer_cat_scores for 'bce'")
    return F.cross_entropy(answer_scores, answer_cat.to(torch.int64))


def aux_situation_loss(
    out: Dict[str, Any],
    batch: Dict[str, Any],
    tag: str,
    cfg: LossConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Position + rotation situation loss."""
    aux = out["aux_scores"].float()
    gt = batch["auxiliary_task"].float()
    diff_fn = torch.square if "__l2__" in tag else torch.abs
    if "__class__" in tag:
        # per-token: channel 0 = position logits over tokens (CE against the
        # Gaussian weights), channels 1: = per-token rotation regression
        logp = F.log_softmax(aux[:, :, 0], dim=-1)
        loss_pos = -(out["auxiliary_task_loc_gt"] * logp).sum(dim=-1).mean()
        loss_rot = diff_fn(aux[:, :, 1:] - gt[:, None, 3:]).mean()
    else:
        loss_pos = diff_fn(aux[:, :3] - gt[:, :3]).mean()
        loss_rot = diff_fn(aux[:, 3:] - gt[:, 3:]).mean()
    loss_aux = cfg.pos_weight * loss_pos + cfg.rot_weight * loss_rot
    return loss_aux, loss_pos, loss_rot


def get_loss(
    out: Dict[str, Any],
    batch: Dict[str, Any],
    cfg: LossConfig,
    tag: str,
    use_aux_situation: bool = True,
    use_answer: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted total loss + per-term dict (keys as in the reference)."""
    zero = torch.zeros((), device=out["answer_scores"].device)
    terms = {"vote_loss": zero, "objectness_loss": zero,
             "box_loss": zero, "sem_cls_loss": zero}
    if use_aux_situation and "aux_scores" in out:
        loss_aux, loss_pos, loss_rot = aux_situation_loss(out, batch, tag, cfg)
    else:
        loss_aux = loss_pos = loss_rot = zero
    terms.update(aux_loss=loss_aux, pos_loss=loss_pos, rot_loss=loss_rot)

    if use_answer:
        terms["answer_loss"] = answer_classification_loss(
            out["answer_scores"], batch.get("answer_cat_scores"),
            batch.get("answer_cat"), cfg.answer_loss)
    else:
        terms["answer_loss"] = zero

    total = (
        cfg.vote_weight * terms["vote_loss"]
        + cfg.objectness_weight * terms["objectness_loss"]
        + cfg.box_weight * terms["box_loss"]
        + cfg.sem_cls_weight * terms["sem_cls_loss"]
        + cfg.aux_situation_weight * terms["aux_loss"]
        + cfg.answer_weight * terms["answer_loss"]
    ) * cfg.amplifier
    terms["loss"] = total
    return total, terms
