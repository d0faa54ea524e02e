"""3D detection evaluation utilities (host, numpy only): the port's own copy
of the reference's ``eval/detection.py``.

3D IoU via polygon clipping, corner helpers and rotation matrices; 2D / 3D /
same-class NMS; VOC-style AP; ``parse_predictions`` / ``parse_groundtruths``
and ``APCalculator``, which turn a VoteNet output dict into boxes and a mean
average precision.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Rotations / corners
# ---------------------------------------------------------------------------

def rotx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def get_3d_box(box_size: Sequence[float], heading: float,
               center: Sequence[float]) -> np.ndarray:
    """8 corners [8, 3] of an upright (z-heading) box."""
    l, w, h = box_size
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    y = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    z = np.array([h, h, h, h, -h, -h, -h, -h]) / 2
    corners = rotz(heading) @ np.vstack([x, y, z])
    return (corners.T + np.asarray(center)).astype(np.float32)


def random_sampling(pc: np.ndarray, num_sample: int, replace=None,
                    return_choices: bool = False):
    """pc_utils.random_sampling."""
    if replace is None:
        replace = pc.shape[0] < num_sample
    choices = np.random.choice(pc.shape[0], num_sample, replace=replace)
    return (pc[choices], choices) if return_choices else pc[choices]


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------

def _polygon_clip(subject: List[Tuple[float, float]],
                  clip: List[Tuple[float, float]]):
    """Sutherland-Hodgman convex clip."""
    def inside(p, a, b):
        # inclusive: points on the clip edge stay (self-IoU must be 1)
        return (b[0] - a[0]) * (p[1] - a[1]) >= (b[1] - a[1]) * (p[0] - a[0])

    def intersect(p1, p2, a, b):
        dc = (a[0] - b[0], a[1] - b[1])
        dp = (p1[0] - p2[0], p1[1] - p2[1])
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p1[0] * p2[1] - p1[1] * p2[0]
        d = dc[0] * dp[1] - dc[1] * dp[0]
        if abs(d) < 1e-12:
            return p2
        return ((n1 * dp[0] - n2 * dc[0]) / d, (n1 * dp[1] - n2 * dc[1]) / d)

    output = subject
    a = clip[-1]
    for b in clip:
        if not output:
            return []
        inputs, output = output, []
        s = inputs[-1]
        for e in inputs:
            if inside(e, a, b):
                if not inside(s, a, b):
                    output.append(intersect(s, e, a, b))
                output.append(e)
            elif inside(s, a, b):
                output.append(intersect(s, e, a, b))
            s = e
        a = b
    return output


def _poly_area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    x = np.array([p[0] for p in poly])
    y = np.array([p[1] for p in poly])
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray) -> Tuple[float, float]:
    """Oriented 3D IoU + BEV 2D IoU from [8, 3] corner sets (box_util.box3d_iou
    semantics: top face first 4 corners, z up)."""
    rect1 = [(c[0], c[1]) for c in corners1[:4]]
    rect2 = [(c[0], c[1]) for c in corners2[:4]]
    # ensure counter-clockwise
    if _signed_area(rect1) < 0:
        rect1 = rect1[::-1]
    if _signed_area(rect2) < 0:
        rect2 = rect2[::-1]
    inter = _poly_area(_polygon_clip(rect1, rect2))
    a1, a2 = _poly_area(rect1), _poly_area(rect2)
    iou_2d = inter / max(a1 + a2 - inter, 1e-12)
    zmax = min(corners1[:, 2].max(), corners2[:, 2].max())
    zmin = max(corners1[:, 2].min(), corners2[:, 2].min())
    h = max(0.0, zmax - zmin)
    vol_i = inter * h
    v1 = a1 * (corners1[:, 2].max() - corners1[:, 2].min())
    v2 = a2 * (corners2[:, 2].max() - corners2[:, 2].min())
    return vol_i / max(v1 + v2 - vol_i, 1e-12), iou_2d


def _signed_area(poly) -> float:
    """Positive for counter-clockwise vertex order."""
    x = np.array([p[0] for p in poly])
    y = np.array([p[1] for p in poly])
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def box3d_iou_aabb(b1: np.ndarray, b2: np.ndarray) -> float:
    """Axis-aligned IoU from [6] = (xmin,ymin,zmin,xmax,ymax,zmax)."""
    mins = np.maximum(b1[:3], b2[:3])
    maxs = np.minimum(b1[3:], b2[3:])
    inter = np.prod(np.maximum(maxs - mins, 0))
    v1 = np.prod(b1[3:] - b1[:3])
    v2 = np.prod(b2[3:] - b2[:3])
    return float(inter / max(v1 + v2 - inter, 1e-12))


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def nms_3d_faster(boxes: np.ndarray, overlap_threshold: float,
                  old_type: bool = False) -> List[int]:
    """boxes [N, 7]: xmin,ymin,zmin,xmax,ymax,zmax,score (nms.py semantics)."""
    order = np.argsort(boxes[:, 6])[::-1]
    keep: List[int] = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        for j in order:
            if j == i or suppressed[j]:
                continue
            mins = np.maximum(boxes[i, :3], boxes[j, :3])
            maxs = np.minimum(boxes[i, 3:6], boxes[j, 3:6])
            inter = np.prod(np.maximum(maxs - mins, 0))
            if old_type:
                vj = np.prod(boxes[j, 3:6] - boxes[j, :3])
                o = inter / max(vj, 1e-12)
            else:
                vi = np.prod(boxes[i, 3:6] - boxes[i, :3])
                vj = np.prod(boxes[j, 3:6] - boxes[j, :3])
                o = inter / max(vi + vj - inter, 1e-12)
            if o > overlap_threshold:
                suppressed[j] = True
    return keep


def nms_3d_faster_samecls(boxes: np.ndarray, overlap_threshold: float,
                          old_type: bool = False) -> List[int]:
    """boxes [N, 8]: ... score, class — suppression only within a class."""
    keep: List[int] = []
    for cls in np.unique(boxes[:, 7]):
        idx = np.flatnonzero(boxes[:, 7] == cls)
        sub = nms_3d_faster(boxes[idx, :7], overlap_threshold, old_type)
        keep.extend(int(idx[k]) for k in sub)
    return keep


# ---------------------------------------------------------------------------
# VOC AP
# ---------------------------------------------------------------------------

def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False
           ) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if (rec >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.flatnonzero(mrec[1:] != mrec[:-1]) + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def eval_det_cls(pred: Dict, gt: Dict, ovthresh: float = 0.25
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Per-class AP (utils/eval_det.py): pred/gt keyed by image id; pred
    values are lists of (corners, score), gt values lists of corners."""
    npos = sum(len(v) for v in gt.values())
    matched = {k: np.zeros(len(v), bool) for k, v in gt.items()}
    records = []
    for img, dets in pred.items():
        for corners, score in dets:
            records.append((score, img, corners))
    records.sort(key=lambda r: -r[0])
    tp = np.zeros(len(records))
    fp = np.zeros(len(records))
    for d, (score, img, corners) in enumerate(records):
        best_iou, best_j = 0.0, -1
        for j, gtc in enumerate(gt.get(img, [])):
            iou, _ = box3d_iou(np.asarray(corners), np.asarray(gtc))
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_iou > ovthresh and not matched[img][best_j]:
            tp[d] = 1
            matched[img][best_j] = True
        else:
            fp[d] = 1
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(npos, 1)
    prec = tp / np.maximum(tp + fp, 1e-12)
    return rec, prec, voc_ap(rec, prec)


class APCalculator:
    """Accumulates (pred, gt) per batch; computes per-class AP + mAP
    (lib/ap_helper.py:225)."""

    def __init__(self, ap_iou_thresh: float = 0.25,
                 class2type: Dict[int, str] = None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type = class2type or {}
        self.reset()

    def reset(self) -> None:
        self.gt: Dict[int, Dict] = defaultdict(dict)
        self.pred: Dict[int, Dict] = defaultdict(dict)
        self.scan_cnt = 0

    def step(self, batch_pred, batch_gt) -> None:
        """batch_pred: list per sample of (cls, corners, score);
        batch_gt: list per sample of (cls, corners)."""
        for preds, gts in zip(batch_pred, batch_gt):
            img = self.scan_cnt
            for cls, corners, score in preds:
                self.pred[cls].setdefault(img, []).append((corners, score))
            for cls, corners in gts:
                self.gt[cls].setdefault(img, []).append(corners)
            self.scan_cnt += 1

    def compute_metrics(self) -> Dict[str, float]:
        out = {}
        aps = []
        for cls in sorted(self.gt.keys()):
            _, _, ap = eval_det_cls(self.pred.get(cls, {}), self.gt[cls],
                                    self.ap_iou_thresh)
            name = self.class2type.get(cls, str(cls))
            out[f"{name} Average Precision"] = ap
            aps.append(ap)
        out["mAP"] = float(np.mean(aps)) if aps else 0.0
        return out


# ---------------------------------------------------------------------------
# Model-output parsing (lib/ap_helper.py:40-141 parse_predictions /
# parse_groundtruths)
# ---------------------------------------------------------------------------

def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def parse_predictions(end_points: Dict[str, np.ndarray], config,
                      conf_thresh: float = 0.05,
                      nms_iou: float = 0.25) -> List[List[Tuple]]:
    """VoteNet output dict -> per-sample [(cls, corners[8,3], score), ...].

    Decodes heading/size classes to boxes (get_3d_box), filters by
    objectness prob, applies per-sample 3D NMS — the parse_predictions flow
    of ap_helper.py with use_3d_nms semantics.
    """
    center = np.asarray(end_points["center"])            # [B, K, 3]
    B, K, _ = center.shape
    obj_prob = _softmax(np.asarray(end_points["objectness_scores"]))[..., 1]
    h_cls = np.asarray(end_points["heading_scores"]).argmax(-1)
    h_res = np.take_along_axis(
        np.asarray(end_points["heading_residuals"]), h_cls[..., None],
        -1)[..., 0]
    s_cls = np.asarray(end_points["size_scores"]).argmax(-1)
    s_res = np.take_along_axis(
        np.asarray(end_points["size_residuals"]),
        s_cls[..., None, None].repeat(3, -1), 2)[:, :, 0]
    sem_cls = np.asarray(end_points["sem_cls_scores"]).argmax(-1)

    batch_pred: List[List[Tuple]] = []
    for b in range(B):
        corners = np.zeros((K, 8, 3))
        for k in range(K):
            size = config.class2size(int(s_cls[b, k]), s_res[b, k])
            angle = config.class2angle(int(h_cls[b, k]), float(h_res[b, k]))
            corners[k] = get_3d_box(np.maximum(size, 1e-4), angle,
                                    center[b, k])
        # axis-aligned NMS boxes [x1,y1,z1,x2,y2,z2,score]
        boxes = np.zeros((K, 7))
        boxes[:, :3] = corners.min(1)
        boxes[:, 3:6] = corners.max(1)
        boxes[:, 6] = obj_prob[b]
        keep = nms_3d_faster(boxes[obj_prob[b] > conf_thresh], nms_iou)
        kept_idx = np.flatnonzero(obj_prob[b] > conf_thresh)[keep]
        batch_pred.append([
            (int(sem_cls[b, k]), corners[k], float(obj_prob[b, k]))
            for k in kept_idx])
    return batch_pred


def parse_groundtruths(batch: Dict[str, np.ndarray], config
                       ) -> List[List[Tuple]]:
    """GT labels -> per-sample [(cls, corners[8,3]), ...] (ap_helper.py
    parse_groundtruths)."""
    center = np.asarray(batch["center_label"])[:, :, :3]
    mask = np.asarray(batch["box_label_mask"])
    h_cls = np.asarray(batch["heading_class_label"])
    h_res = np.asarray(batch["heading_residual_label"])
    s_cls = np.asarray(batch["size_class_label"])
    s_res = np.asarray(batch["size_residual_label"])
    sem = np.asarray(batch["sem_cls_label"])
    B, K2 = center.shape[:2]
    out: List[List[Tuple]] = []
    for b in range(B):
        gts = []
        for k in range(K2):
            if mask[b, k] < 0.5:
                continue
            size = config.class2size(int(s_cls[b, k]), s_res[b, k])
            angle = config.class2angle(int(h_cls[b, k]), float(h_res[b, k]))
            gts.append((int(sem[b, k]),
                        get_3d_box(np.maximum(size, 1e-4), angle,
                                   center[b, k])))
        out.append(gts)
    return out
