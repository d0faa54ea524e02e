"""SQA3D dataset pipeline on the host (port of
``situation3d_tpu/data/sqa3d.py``, which re-implements the reference's
``lib/sepdataset.py`` ScannetQADataset + SQA3D_collate_fn for fixed-shape
batches). numpy throughout; the batches go to the device in the trainer.

- ``SQA_{split}.json`` QA records + per-scene OpenScene ``.pth`` point clouds
  (``locs, feats, labels``) and ScanNet ``.txt`` axis-align matrices
  (``sepdataset.py:415-456``);
- situation pose -> axis-aligned frame (undo bounding-sphere centering, apply
  axis_align_matrix to position and rotation, ``sepdataset.py:224-238``);
- train-time augmentation (mirror / rot-z; the reference's default enables
  only rot-z +-5 deg, ``lib/config.py:83-87``);
- translate-to-origin then voxelize @0.02 m (``sepdataset.py:297-305``);
- 7/5/9-D auxiliary situation target by loss tag (``sepdataset.py:306-313``);
- answer one-hots + binary BCE scores (``sepdataset.py:180-196``) and the
  9-way question type (``language_util.py:1-21``).

Samples pad to the fixed ``voxel_capacity`` so batches have static shapes.
Every draw of ``SQA3DDataset.rng`` (mirror, rot-z, the overflow subset) and
``batch_iterator``'s permutation come in the reference's order, so the same
files and seed give the same batches, bit for bit.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from situation3d_tpu_torch.config import Config
from situation3d_tpu_torch.data.tokenizer import make_tokenizer
from situation3d_tpu_torch.data.vocab import AnswerVocab, answer_score
from situation3d_tpu_torch.ops.voxelize import voxelize_np


def question_type_id(question: str) -> int:
    """First-word bucketing (situation3d/utils/language_util.py:1-21)."""
    first = question.split()[0].lower() if question.split() else ""
    table = {"what": 0, "is": 1, "are": 1, "how": 2, "can": 3, "which": 4,
             "if": 5, "where": 6, "am": 7}
    return table.get(first, 8)


def _rot(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, (-s if axis != 1 else s), (
        s if axis != 1 else -s), c
    return m


def situation_target(coord: np.ndarray, quat: np.ndarray, tag: str) -> np.ndarray:
    """7/5/9-D auxiliary target (sepdataset.py:306-313)."""
    if "__quat__" in tag:
        return np.concatenate([coord, quat]).astype(np.float32)
    if "__angle__" in tag:
        a = R.from_quat(quat).as_rotvec()[-1]
        return np.concatenate([coord, [np.sin(a), np.cos(a)]]).astype(np.float32)
    if "__6d__" in tag:
        m6 = R.from_quat(quat).as_matrix()[:2].reshape(-1)
        return np.concatenate([coord, m6]).astype(np.float32)
    raise NotImplementedError(tag)


@dataclass
class SceneData:
    points: np.ndarray       # [N, 3] axis-aligned float
    colors: np.ndarray       # [N, 3] 0..255
    labels: np.ndarray       # [N]
    bs_center: np.ndarray    # [3]
    axis_align: np.ndarray   # [4, 4]


def load_scene(scene_dir: str, scans_dir: Optional[str], scene_id: str) -> SceneData:
    """Load one OpenScene .pth scene + axis-align meta (sepdataset.py:427-456).
    The ``.pth`` holds a pickled tuple of arrays, so it is read with
    ``weights_only=False``, as the reference reads it: load only files you
    trust."""
    path = None
    for split in ("train", "val"):
        p = os.path.join(scene_dir, split, f"{scene_id}_vh_clean_2.pth")
        if os.path.exists(p):
            path = p
            break
    if path is None:
        raise FileNotFoundError(f"scene {scene_id} not under {scene_dir}")
    locs, feats, labels = torch.load(path, weights_only=False)
    labels = np.asarray(labels)
    labels[labels == -100] = 255
    feats = (np.asarray(feats) + 1.0) * 127.5

    axis_align = np.eye(4)
    if scans_dir:
        meta = os.path.join(scans_dir, scene_id, f"{scene_id}.txt")
        if os.path.exists(meta):
            with open(meta) as fh:
                lines = fh.readlines()
            for line in lines:
                if "axisAlignment" in line:
                    vals = [float(x) for x in
                            line.rstrip().strip("axisAlignment = ").split(" ")]
                    axis_align = np.array(vals).reshape(4, 4)
    locs = np.asarray(locs)
    bs_center = (locs.max(0) + locs.min(0)) / 2
    pts = np.ones((len(locs), 4))
    pts[:, :3] = locs
    aligned = (pts @ axis_align.T)[:, :3]
    return SceneData(aligned, feats, labels.astype(np.uint8), bs_center, axis_align)


class SQA3DDataset:
    """QA records + scenes -> fixed-shape numpy samples."""

    def __init__(self, cfg: Config, split: str, answer_vocab: AnswerVocab,
                 answer_counter: Optional[Dict[str, int]] = None,
                 records: Optional[List[dict]] = None,
                 scenes: Optional[Dict[str, SceneData]] = None,
                 scans_dir: Optional[str] = None,
                 include_labels: bool = False):
        self.cfg = cfg
        self.split = split
        self.vocab = answer_vocab
        self.answer_counter = answer_counter or {}
        self.tokenizer = make_tokenizer(cfg.data.tokenizer,
                                        vocab_size=cfg.lang.vocab_size)
        if records is None:
            path = {"train": cfg.data.sqa_train, "val": cfg.data.sqa_val,
                    "test": cfg.data.sqa_test}[split]
            with open(path) as fh:
                records = json.load(fh)
        self.records = records
        self.scenes = scenes if scenes is not None else {}
        self._scene_dir = cfg.data.scene_dir
        self._scans_dir = scans_dir if scans_dir is not None \
            else getattr(cfg.data, "scans_dir", None)
        self.tag = cfg.model.situation_loss_tag
        self.include_labels = include_labels  # per-voxel GT labels for seg eval
        self.rng = np.random.RandomState(cfg.data.seed)

    def __len__(self) -> int:
        return len(self.records)

    def _scene(self, scene_id: str) -> SceneData:
        if scene_id not in self.scenes:
            self.scenes[scene_id] = load_scene(
                self._scene_dir, self._scans_dir, scene_id)
        return self.scenes[scene_id]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        cfg = self.cfg
        rec = self.records[idx]
        scene = self._scene(rec["scene_id"])

        # --- situation pose into the axis-aligned frame -------------------
        pos = np.asarray(rec["position"], np.float64)
        coord = pos[:3] + scene.bs_center
        hom = np.ones(4)
        hom[:3] = coord
        coord = (scene.axis_align @ hom)[:3]
        quat = pos[3:7]
        rot_m = scene.axis_align[:3, :3] @ R.from_quat(quat).as_matrix()
        quat = R.from_matrix(rot_m).as_quat()

        points = scene.points.copy()
        colors = scene.colors

        # --- augmentation -------------------------------------------------
        if self.split == "train" and cfg.data.use_augmentation:
            if cfg.data.aug_mirror:
                if self.rng.random_sample() > 0.5:
                    points[:, 0] *= -1
                    coord[0] *= -1
                    m = R.from_quat(quat).as_matrix()
                    m[0, 0] *= -1
                    m[1, 1] *= -1
                    quat = R.from_matrix(m).as_quat()
            if cfg.data.aug_rot_z:
                ang = (self.rng.random_sample() * np.pi / 18) - np.pi / 36
                m = _rot(2, ang)
                points = points @ m.T
                coord = m @ coord
                quat = R.from_matrix(m @ R.from_quat(quat).as_matrix()).as_quat()

        # --- translate to origin + voxelize -------------------------------
        mins = points.min(0)
        points = points - mins
        coord = coord - mins
        vox_coords, first_idx, _ = voxelize_np(points, cfg.data.voxel_size)
        vox_colors = colors[first_idx]
        vox_labels = scene.labels[first_idx]

        cap = cfg.data.voxel_capacity
        n = min(len(vox_coords), cap)
        if len(vox_coords) > cap:  # keep a random subset under overflow
            sel = self.rng.choice(len(vox_coords), cap, replace=False)
            vox_coords, vox_colors = vox_coords[sel], vox_colors[sel]
            vox_labels = vox_labels[sel]
            n = cap
        out_coords = np.zeros((cap, 3), np.int32)
        out_feats = np.zeros((cap, 3), np.float32)
        out_mask = np.zeros(cap, bool)
        out_labels = np.full(cap, 255, np.uint8)  # 255 == UNKNOWN_ID pad
        out_coords[:n] = vox_coords[:n]
        out_feats[:n] = vox_colors[:n]
        out_mask[:n] = True
        out_labels[:n] = vox_labels[:n]

        # --- language -----------------------------------------------------
        s_ids, s_mask = self.tokenizer.encode(
            rec.get("situation", ""), cfg.data.max_text_len)
        q_ids, q_mask = self.tokenizer.encode(
            rec.get("question", ""), cfg.data.max_text_len)

        # --- answers ------------------------------------------------------
        A = len(self.vocab)
        cats = np.zeros(A, np.float32)
        scores = np.zeros(A, np.float32)
        for ans in rec.get("answers", []):
            i = self.vocab.stoi(ans)
            if i >= 0:
                cats[i] = 1
                scores[i] = answer_score(self.answer_counter.get(ans, 1))

        qid = rec.get("question_id", idx)
        if isinstance(qid, str):
            qid = int(qid.split("-")[-1])
        item = {
            "s_ids": s_ids, "s_mask": s_mask, "q_ids": q_ids, "q_mask": q_mask,
            "voxel_coords": out_coords, "voxel_feats": out_feats,
            "voxel_mask": out_mask,
            "auxiliary_task": situation_target(coord, quat, self.tag),
            "answer_cats": cats, "answer_cat_scores": scores,
            "answer_cat": np.int32(cats.argmax()),
            "question_type": np.int32(question_type_id(rec.get("question", ""))),
            "question_id": np.int32(qid),
        }
        if self.include_labels:
            item["voxel_labels"] = out_labels
        return item


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True,
                   epochs: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Stack samples into fixed-shape batches; pads the final partial batch
    with repeats and marks them via ``sample_valid`` (eval parity with the
    reference's non-dropping loader). ``epochs=None`` yields exactly one
    pass over the dataset."""
    rng = np.random.RandomState(seed)
    n = len(dataset)
    for _ in range(1 if epochs is None else epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n, batch_size):
            idxs = order[start:start + batch_size]
            valid = np.ones(batch_size, bool)
            if len(idxs) < batch_size:
                if drop_last:
                    continue
                pad = np.resize(idxs, batch_size - len(idxs))
                valid[len(idxs):] = False
                idxs = np.concatenate([idxs, pad])
            samples = [dataset[int(i)] for i in idxs]
            batch = {k: np.stack([s[k] for s in samples])
                     for k in samples[0]}
            batch["sample_valid"] = valid
            yield batch
