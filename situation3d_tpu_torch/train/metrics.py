"""Evaluation metrics (port of ``situation3d_tpu/train/metrics.py``): answer
EM@1 / EM@10 with the 9-way question-type breakdown as tensor functions, and
the situation position / rotation accuracy as a numpy + scipy host function.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

QUESTION_TYPES = ("what", "isare", "how", "can", "which", "if", "where", "am", "other")


def answer_metrics(
    answer_scores: torch.Tensor,
    answer_cats: torch.Tensor,
    question_type: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """EM@1, EM@10 and question-type breakdown.

    answer_scores [B, A] logits; answer_cats [B, A] multi-hot; question_type
    [B] in [0, 9); valid [B] mask for padded eval batches. Breakdown entries
    are (correct_count, question_count) pairs like the reference.
    """
    B, A = answer_scores.shape
    v = (torch.ones(B, device=answer_scores.device) if valid is None
         else valid.to(torch.float32))
    n = v.sum().clamp(min=1.0)

    pred1 = answer_scores.argmax(dim=1)
    correct1 = torch.gather(answer_cats, 1, pred1[:, None])[:, 0]
    correct1 = (correct1 > 0).to(torch.float32) * v

    top_idx = torch.topk(answer_scores, min(10, A), dim=1).indices
    hits = torch.gather(answer_cats, 1, top_idx)
    correct10 = (hits.max(dim=1).values > 0).to(torch.float32) * v

    out = {"answer_acc_at1": correct1.sum() / n,
           "answer_acc_at10": correct10.sum() / n}
    if question_type is not None:
        for i, name in enumerate(QUESTION_TYPES):
            m = (question_type == i).to(torch.float32) * v
            out[f"answer_acc_breakdown_{name}"] = torch.stack(
                [(correct1 * m).sum(), m.sum()])
    return out


# ---------------------------------------------------------------------------
# Situation metrics (host / numpy, scipy rotations)
# ---------------------------------------------------------------------------

def _rot_z_from_quat(q: np.ndarray) -> float:
    from scipy.spatial.transform import Rotation as R
    return R.from_quat(q).as_rotvec()[-1]


def _rot_z_from_6d(rot: np.ndarray) -> float:
    from scipy.spatial.transform import Rotation as R
    m = np.zeros((3, 3))
    m[:2] = rot.reshape(2, 3)
    m[2] = np.cross(m[0], m[1])
    nrm = np.linalg.norm(m[2])
    m[2] /= nrm if nrm > 0 else 1.0
    return R.from_matrix(m).as_rotvec()[-1]


def _angdiff_deg(r1: float, r2: float) -> float:
    d = abs(r1 - r2)
    return min(d, 2 * math.pi - d) / math.pi * 180.0


def metric_localization(
    gt_pos: np.ndarray,
    gt_rot: np.ndarray,
    pred_pos: np.ndarray,
    pred_rot: np.ndarray,
    tag: str,
    valid: Optional[np.ndarray] = None,
) -> Tuple[float, float, float, float]:
    """Situation accuracy @0.5m/@1.0m (xy only) and @15deg/@30deg (z rotation).

    For ``__class__`` tags ``pred_pos`` is per-token logits — resolve to the
    argmax token's position upstream before calling.
    """
    n_tot = 0
    c05 = c10 = c15 = c30 = 0
    for i in range(len(gt_pos)):
        if valid is not None and not valid[i]:
            continue
        n_tot += 1
        posdiff = float(np.linalg.norm(gt_pos[i][:2] - pred_pos[i][:2]))
        if "__quat__" in tag:
            r1 = _rot_z_from_quat(gt_rot[i])
            nrm = np.linalg.norm(pred_rot[i])
            r2 = _rot_z_from_quat(pred_rot[i] / (nrm if nrm > 0 else 1.0))
            rotdiff = _angdiff_deg(r1, r2)
        elif "__angle__" in tag:
            mag = math.hypot(pred_rot[i][0], pred_rot[i][1]) or 1.0
            r1 = math.atan2(gt_rot[i][0], gt_rot[i][1])
            r2 = math.atan2(pred_rot[i][0] / mag, pred_rot[i][1] / mag)
            rotdiff = _angdiff_deg(r1, r2)
        elif "__6d__" in tag:
            rotdiff = _angdiff_deg(_rot_z_from_6d(gt_rot[i]), _rot_z_from_6d(pred_rot[i]))
        else:
            raise NotImplementedError(tag)
        c05 += posdiff < 0.5
        c10 += posdiff < 1.0
        c15 += rotdiff < 15.0
        c30 += rotdiff < 30.0
    n_tot = max(n_tot, 1)
    return c05 / n_tot, c10 / n_tot, c15 / n_tot, c30 / n_tot


def situation_metrics(
    out: Dict[str, np.ndarray],
    batch: Dict[str, np.ndarray],
    tag: str,
    valid: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Host-side wrapper: picks the predicted position and rotation out of
    ``aux_scores`` for the tag and scores them."""
    gt = np.asarray(batch["auxiliary_task"])
    aux = np.asarray(out["aux_scores"])
    if "__class__" in tag:
        # argmax token position as the predicted position
        tok = np.argmax(aux[:, :, 0], axis=1)
        positions = np.asarray(out["scene_positions"])
        pred_pos = np.concatenate(
            [positions[np.arange(len(tok)), tok],
             np.zeros((len(tok), 1), positions.dtype)], axis=1)
        pred_rot = aux[np.arange(len(tok)), tok, 1:]
    else:
        pred_pos, pred_rot = aux[:, :3], aux[:, 3:]
    a1, a2, a3, a4 = metric_localization(gt[:, :3], gt[:, 3:], pred_pos, pred_rot,
                                         tag, valid)
    return {"situation_acc_0_5m": a1, "situation_acc_1_0m": a2,
            "situation_acc_15deg": a3, "situation_acc_30deg": a4}
