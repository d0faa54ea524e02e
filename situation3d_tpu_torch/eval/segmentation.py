"""3D semantic segmentation evaluation (the port's own copy of
``situation3d_tpu/eval/segmentation.py``, which re-implements
``situation3d/utils/segmentation_util.py``): confusion-matrix mIoU over the
OpenScene head's CLIP-space logits (``openscene_out @ text_features.T`` vs
labels, ``eval.py:293-332``), the ScanNet-20 label set and palette, and the
prompt templates for text features (the CLIP text encoder is an injectable
callable: the reference downloads CLIP ViT-L/14@336px; any text-embedding
function with the same signature works).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np

SCANNET_LABELS_20 = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture")

# the reference's prompt-engineering templates (segmentation_util.py:186-)
PROMPT_TEMPLATES = (
    "a {} in a scene",
    "a photo of a {} in the scene",
    "there is the {} in the scene",
    "this is a {} in the scene",
)

UNKNOWN_ID = 255


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int
                     ) -> np.ndarray:
    """[C, C] confusion over valid (gt != UNKNOWN_ID) points
    (segmentation_util.evaluate:85)."""
    valid = gt != UNKNOWN_ID
    p, g = pred[valid].astype(np.int64), gt[valid].astype(np.int64)
    keep = (g >= 0) & (g < num_classes) & (p >= 0) & (p < num_classes)
    idx = g[keep] * num_classes + p[keep]
    return np.bincount(idx, minlength=num_classes ** 2).reshape(
        num_classes, num_classes)


def miou_from_confusion(conf: np.ndarray) -> Tuple[float, np.ndarray]:
    tp = np.diag(conf).astype(np.float64)
    fp = conf.sum(0) - tp
    fn = conf.sum(1) - tp
    denom = tp + fp + fn
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
    return float(np.nanmean(iou)), iou


def evaluate(pred_ids: np.ndarray, gt_ids: np.ndarray,
             class_labels: Sequence[str] = SCANNET_LABELS_20
             ) -> Dict[str, float]:
    """mIoU + accuracy + per-class IoUs (segmentation_util.evaluate)."""
    n = len(class_labels)
    conf = confusion_matrix(pred_ids, gt_ids, n)
    miou, ious = miou_from_confusion(conf)
    valid = gt_ids != UNKNOWN_ID
    acc = float((pred_ids[valid] == gt_ids[valid]).mean()) if valid.any() else 0.0
    out = {"mIoU": miou, "accuracy": acc}
    for name, iou in zip(class_labels, ious):
        out[f"iou/{name}"] = float(iou)
    return out


def precompute_text_features(
    encode_text: Callable[[Sequence[str]], np.ndarray],
    class_labels: Sequence[str] = SCANNET_LABELS_20,
    templates: Sequence[str] = PROMPT_TEMPLATES,
) -> np.ndarray:
    """Prompt-ensembled, L2-normalized per-class text features
    (segmentation_util.extract_clip_feature / precompute_text_related_properties).

    ``encode_text`` maps a list of strings to [K, D] embeddings (a CLIP text
    encoder in the reference)."""
    feats = []
    for label in class_labels:
        prompts = [t.format(label) for t in templates]
        e = np.asarray(encode_text(prompts))
        e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
        mean = e.mean(0)
        feats.append(mean / np.maximum(np.linalg.norm(mean), 1e-12))
    return np.stack(feats)


def segment_points(point_features: np.ndarray, text_features: np.ndarray
                   ) -> np.ndarray:
    """Per-point class ids via feature-space similarity
    (eval.py:293-297: openscene_out[inds_reconstruct] @ text_features.T)."""
    logits = point_features @ text_features.T
    return logits.argmax(-1)


# ScanNet-20 color palette (segmentation_util palettes)
SCANNET_PALETTE = np.array([
    [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120],
    [188, 189, 34], [140, 86, 75], [255, 152, 150], [214, 39, 40],
    [197, 176, 213], [148, 103, 189], [196, 156, 148], [23, 190, 207],
    [247, 182, 210], [219, 219, 141], [255, 127, 14], [158, 218, 229],
    [44, 160, 44], [112, 128, 144], [227, 119, 194], [82, 84, 163],
], np.uint8)
