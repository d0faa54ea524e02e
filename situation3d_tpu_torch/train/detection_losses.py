"""VoteNet detection losses: the port of the reference's
``train/detection_losses.py`` (``compute_vote_loss``,
``compute_objectness_loss``, ``compute_box_and_sem_cls_loss``,
``get_detection_loss``), with the same masking and normalization. Plain
PyTorch; label lookups are ``torch.gather`` (no gradient reaches a label)."""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from situation3d_tpu_torch.ops.nn_distance import huber_loss, nn_distance

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.to(torch.int64))


def _cross_entropy(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element softmax cross entropy with integer labels, in float32."""
    return F.cross_entropy(scores.float().flatten(0, -2), labels.to(torch.int64).flatten(),
                           reduction="none").view(labels.shape)


def compute_vote_loss(dd: Dict[str, Any]) -> torch.Tensor:
    B, num_seed, _ = dd["seed_xyz"].shape
    vote_xyz = dd["vote_xyz"]
    seed_inds = dd["seed_inds"].to(torch.int64)

    gt_mask = _take(dd["vote_label_mask"], seed_inds).float()
    inds9 = seed_inds[..., None].expand(B, num_seed, 3 * GT_VOTE_FACTOR)
    gt_votes = _take(dd["vote_label"], inds9)
    gt_votes = gt_votes + dd["seed_xyz"].repeat(1, 1, GT_VOTE_FACTOR)

    vr = vote_xyz.reshape(B * num_seed, -1, 3)
    gr = gt_votes.reshape(B * num_seed, GT_VOTE_FACTOR, 3)
    _, _, dist2, _ = nn_distance(vr, gr, l1=True)
    votes_dist = dist2.amin(dim=1).view(B, num_seed)
    return (votes_dist * gt_mask).sum() / (gt_mask.sum() + 1e-6)


def compute_objectness_loss(dd: Dict[str, Any]):
    agg = dd["aggregated_vote_xyz"]
    gt_center = dd["center_label"][:, :, :3]
    dist1, ind1, _, _ = nn_distance(agg, gt_center)
    e1 = torch.sqrt(dist1 + 1e-6)
    label = (e1 < NEAR_THRESHOLD).to(torch.int32)
    mask = ((e1 < NEAR_THRESHOLD) | (e1 > FAR_THRESHOLD)).float()

    scores = dd["objectness_scores"]                  # [B, K, 2]
    w = torch.tensor(OBJECTNESS_CLS_WEIGHTS, dtype=torch.float32, device=scores.device)
    per = _cross_entropy(scores, label) * w[label.to(torch.int64)]
    loss = (per * mask).sum() / (mask.sum() + 1e-6)
    return loss, label, mask, ind1


def compute_box_and_sem_cls_loss(dd: Dict[str, Any], config) -> Tuple:
    assign = dd["object_assignment"].to(torch.int64)
    obj = dd["objectness_label"].float()
    n_obj = obj.sum() + 1e-6

    pred_center = dd["center"]
    gt_center = dd["center_label"][:, :, :3]
    dist1, _, dist2, _ = nn_distance(pred_center, gt_center)
    box_mask = dd["box_label_mask"].float()
    center_loss = ((dist1 * obj).sum() / n_obj
                   + (dist2 * box_mask).sum() / (box_mask.sum() + 1e-6))

    def masked_ce(scores, labels):
        return (_cross_entropy(scores, labels) * obj).sum() / n_obj

    h_lbl = _take(dd["heading_class_label"].to(torch.int64), assign)
    heading_cls_loss = masked_ce(dd["heading_scores"], h_lbl)
    h_res_lbl = _take(dd["heading_residual_label"], assign) / (
        math.pi / config.num_heading_bin)
    h_onehot = F.one_hot(h_lbl, config.num_heading_bin).float()
    h_res = (dd["heading_residuals_normalized"] * h_onehot).sum(-1)
    heading_reg_loss = (huber_loss(h_res - h_res_lbl) * obj).sum() / n_obj

    s_lbl = _take(dd["size_class_label"].to(torch.int64), assign)
    size_cls_loss = masked_ce(dd["size_scores"], s_lbl)
    s_res_lbl = _take(dd["size_residual_label"], assign[..., None].expand(-1, -1, 3))
    s_onehot = F.one_hot(s_lbl, config.num_size_cluster).float()[..., None]
    pred_res = (dd["size_residuals_normalized"] * s_onehot).sum(2)
    mean_size_arr = torch.as_tensor(config.mean_size_arr, dtype=torch.float32,
                                    device=s_onehot.device)
    mean_size = (s_onehot * mean_size_arr[None, None]).sum(2)
    s_res_norm = s_res_lbl / mean_size
    size_reg_loss = (huber_loss(pred_res - s_res_norm).mean(-1) * obj).sum() / n_obj

    sem_lbl = _take(dd["sem_cls_label"].to(torch.int64), assign)
    sem_cls_loss = masked_ce(dd["sem_cls_scores"], sem_lbl)
    return (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss,
            size_reg_loss, sem_cls_loss)


def get_detection_loss(dd: Dict[str, Any], config
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Composite detection loss: vote + 0.5 objectness + box (centre + 0.1
    heading class + heading residual + 0.1 size class + size residual) + 0.1
    semantic class. ``dd`` holds the model's outputs and the labels."""
    vote_loss = compute_vote_loss(dd)
    obj_loss, obj_label, obj_mask, assign = compute_objectness_loss(dd)
    dd = dict(dd, objectness_label=obj_label, objectness_mask=obj_mask,
              object_assignment=assign)
    c, hc, hr, sc, sr, sem = compute_box_and_sem_cls_loss(dd, config)
    box_loss = c + 0.1 * hc + hr + 0.1 * sc + sr
    total = vote_loss + 0.5 * obj_loss + box_loss + 0.1 * sem
    return total, {
        "vote_loss": vote_loss, "objectness_loss": obj_loss,
        "center_loss": c, "heading_cls_loss": hc, "heading_reg_loss": hr,
        "size_cls_loss": sc, "size_reg_loss": sr, "sem_cls_loss": sem,
        "box_loss": box_loss,
    }
