"""Synthetic data for smoke runs and tests, made with numpy from the
caller's seed or ``RandomState``.

``make_synthetic_dataset`` (port of ``situation3d_tpu/data/synthetic.py``):
random room-like scenes and QA records with the schema of the real pipeline,
served by ``data/sqa3d.py:SQA3DDataset`` exactly as files would be; the
training CLI's ``--synthetic``.

``write_sqa3d_files``: scenes and QA records written in the file layout the
SQA3D pipeline reads, for runs of the entry points on files.

``make_detection_batch``: a room of points on a floor, four walls and the
faces of a few axis-aligned boxes, with the labels the detection loss and the
box parser read (VoteNet path). It is smoke and test data, not a dataset.

``make_scene_batch``: the pinned scene batch used to exercise and time the
SIG3D forward and training step: random points in an 8 x 6 x 3 m box
voxelized at the configured voxel size, random colors, fixed-length random
token ids, one random answer per sample (the forward's fields are the same
draws, in the same order, as the reference benchmark's batch; the training
targets are drawn after them)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from situation3d_tpu_torch.data.sqa3d import SceneData, SQA3DDataset
from situation3d_tpu_torch.data.vocab import AnswerVocab
from situation3d_tpu_torch.device import resolve_device

_QUESTIONS = [
    "what is on the table", "is the chair red", "how many windows are there",
    "can i reach the door", "which side is the bed", "if i turn left what do i see",
    "where is the lamp", "am i facing the window", "describe the room",
]
_SITUATIONS = [
    "i am standing next to the table facing the door",
    "sitting on the sofa with the window on my left",
    "leaning on the counter looking at the shelf",
]
_ANSWERS = ["table", "chair", "red", "two", "yes", "no", "left", "right",
            "window", "door", "lamp", "bed"]


def synthetic_scene(rng: np.random.RandomState, n_points: int = 30000,
                    extent=(6.0, 5.0, 2.8)) -> SceneData:
    pts = rng.rand(n_points, 3) * np.asarray(extent)
    # bias to walls/floor so density resembles a scanned room
    wall = rng.rand(n_points) < 0.4
    pts[wall, 2] = np.abs(rng.randn(wall.sum()) * 0.05)
    colors = rng.rand(n_points, 3) * 255.0
    labels = rng.randint(0, 20, n_points).astype(np.uint8)
    return SceneData(points=pts.astype(np.float64), colors=colors,
                     labels=labels, bs_center=pts.mean(0),
                     axis_align=np.eye(4))


def synthetic_records(rng, scene_ids: List[str], per_scene: int,
                      extent=(6.0, 5.0, 2.8)) -> List[dict]:
    records = []
    for sid in scene_ids:
        for k in range(per_scene):
            yaw = rng.rand() * 2 * np.pi
            quat = R.from_rotvec([0, 0, yaw]).as_quat()
            pos = list(rng.rand(3) * np.asarray(extent) * 0.5) + list(quat)
            records.append({
                "scene_id": sid,
                "position": pos,
                "question_id": f"synthetic-{sid}-{k}",
                "situation": _SITUATIONS[k % len(_SITUATIONS)],
                "question": _QUESTIONS[k % len(_QUESTIONS)],
                "answers": [str(np.asarray(_ANSWERS)[rng.randint(len(_ANSWERS))])],
            })
    return records


def write_sqa3d_files(root: str, scenes: Dict[str, dict],
                      records: Dict[str, List[dict]],
                      answer_counter: Dict[str, int]) -> List[str]:
    """Write the layout ``data/sqa3d.py`` reads (``lib/sepdataset.py:415-456``):
    ``{root}/scannet_3d/{split}/{scene}_vh_clean_2.pth`` holding the tuple
    ``(locs float32 [N, 3], feats in [-1, 1] [N, 3], labels int64 [N], -100
    unannotated)``, the ScanNet meta ``{root}/scans/{scene}/{scene}.txt``
    with its ``axisAlignment = ...`` line, ``{root}/sqa/SQA_{split}.json`` and
    ``{root}/sqa/answer_counter.json``. ``scenes``: scene id -> ``{"split",
    "locs", "feats", "labels", "axis_align" [4, 4]}``; ``records``: split ->
    QA records. Returns the ``data.*`` overrides that point a config there."""
    sqa = os.path.join(root, "sqa")
    os.makedirs(sqa, exist_ok=True)
    for sid, sc in scenes.items():
        d = os.path.join(root, "scannet_3d", sc["split"])
        os.makedirs(d, exist_ok=True)
        torch.save((sc["locs"], sc["feats"], sc["labels"]),
                   os.path.join(d, f"{sid}_vh_clean_2.pth"))
        meta = os.path.join(root, "scans", sid)
        os.makedirs(meta, exist_ok=True)
        with open(os.path.join(meta, f"{sid}.txt"), "w") as fh:
            fh.write("colorHeight = 968\n")
            fh.write("axisAlignment = " + " ".join(
                f"{v:.6f}" for v in np.asarray(sc["axis_align"]).ravel()) + "\n")
    for split, recs in records.items():
        with open(os.path.join(sqa, f"SQA_{split}.json"), "w") as fh:
            json.dump(recs, fh)
    with open(os.path.join(sqa, "answer_counter.json"), "w") as fh:
        json.dump(answer_counter, fh)
    return [f"data.sqa_{split}={sqa}/SQA_{split}.json" for split in records] + [
        f"data.answer_counter={sqa}/answer_counter.json",
        f"data.scene_dir={root}/scannet_3d", f"data.scans_dir={root}/scans"]


def make_synthetic_dataset(cfg, n_scenes: int = 2, per_scene: int = 4,
                           split: str = "train", n_points: int = 30000,
                           seed: int = 0,
                           include_labels: bool = False) -> SQA3DDataset:
    """``n_scenes`` scenes of ``n_points`` points and ``per_scene`` records
    each, with the 12-answer vocabulary of ``_ANSWERS``."""
    rng = np.random.RandomState(seed)
    scene_ids = [f"scene{i:04d}_00" for i in range(n_scenes)]
    scenes = {sid: synthetic_scene(rng, n_points) for sid in scene_ids}
    records = synthetic_records(rng, scene_ids, per_scene)
    vocab = AnswerVocab(_ANSWERS)
    counter = {a: 5 for a in _ANSWERS}
    return SQA3DDataset(cfg, split, vocab, counter, records=records,
                        scenes=scenes, include_labels=include_labels)


def make_scene_batch(cfg, B: int, rng: np.random.RandomState, device="cuda"):
    """Returns ``(batch dict of tensors on device, coords ndarray, mask ndarray)``."""
    dev = resolve_device(device)
    cap = cfg.sparse.capacities[0]
    L = cfg.data.max_text_len
    coords = np.zeros((B, cap, 3), np.int32)
    mask = np.zeros((B, cap), bool)
    feats = np.zeros((B, cap, 3), np.float32)
    for b in range(B):
        pts = (rng.rand(50000, 3) * np.array([8.0, 6.0, 3.0])) / cfg.data.voxel_size
        c = np.unique(np.floor(pts).astype(np.int32), axis=0)[:cap]
        coords[b, : len(c)], mask[b, : len(c)] = c, True
        feats[b, : len(c)] = rng.rand(len(c), 3) * 255
    sm = np.zeros((B, L), np.int32); sm[:, :60] = 1
    qm = np.zeros((B, L), np.int32); qm[:, :20] = 1
    A = cfg.data.num_answers
    top = min(30000, cfg.lang.vocab_size)       # 30000 at the default vocabulary
    cats = np.eye(A, dtype=np.float32)[rng.randint(0, A, B)]
    batch = {
        "s_ids": rng.randint(4, top, (B, L)).astype(np.int32),
        "s_mask": sm,
        "q_ids": rng.randint(4, top, (B, L)).astype(np.int32),
        "q_mask": qm,
        "voxel_coords": coords,
        "voxel_feats": feats,
        "voxel_mask": mask,
        "auxiliary_task": np.concatenate(
            [rng.rand(B, 3) * 4, np.tile([0, 0, 0, 1.0], (B, 1))], 1
        ).astype(np.float32),
        "answer_cat_scores": cats,
        # training / evaluation targets
        "answer_cat": cats.argmax(1).astype(np.int32),
        "question_type": rng.randint(0, 9, B).astype(np.int32),
        "sample_valid": np.ones(B, bool),
    }
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}, coords, mask


def make_detection_arrays(B: int, N: int, rng: np.random.RandomState,
                          mean_size_arr: Optional[np.ndarray] = None,
                          room: Sequence[float] = (8.0, 6.0, 3.0),
                          max_boxes: int = 64, num_boxes: Sequence[int] = (4, 10)
                          ) -> Dict[str, np.ndarray]:
    """One detection batch as numpy arrays.

    Per scene ``N`` points in a ``room`` (metres, one corner at the origin):
    35% on the floor, 30% on the walls, the rest on the top and side faces of
    ``num_boxes[0]..num_boxes[1]`` axis-aligned boxes standing on the floor,
    in shuffled order. Labels, padded to ``max_boxes``: ``center_label``,
    ``box_label_mask``, heading class / residual (all zero: axis-aligned),
    ``size_class_label`` (= the semantic class) and ``size_residual_label``
    (size minus ``mean_size_arr[class]``; ones by default, as
    ``ScannetDatasetConfig``'s), ``sem_cls_label``; per point ``vote_label``
    (offset to its box's centre, three times; zero off a box) and
    ``vote_label_mask``."""
    rx, ry, rz = (float(v) for v in room)
    if mean_size_arr is None:
        mean_size_arr = np.ones((18, 3), np.float32)
    out = {
        "point_clouds": np.zeros((B, N, 3), np.float32),
        "vote_label": np.zeros((B, N, 9), np.float32),
        "vote_label_mask": np.zeros((B, N), np.int32),
        "center_label": np.zeros((B, max_boxes, 3), np.float32),
        "box_label_mask": np.zeros((B, max_boxes), np.float32),
        "heading_class_label": np.zeros((B, max_boxes), np.int32),
        "heading_residual_label": np.zeros((B, max_boxes), np.float32),
        "size_class_label": np.zeros((B, max_boxes), np.int32),
        "size_residual_label": np.zeros((B, max_boxes, 3), np.float32),
        "sem_cls_label": np.zeros((B, max_boxes), np.int32),
    }
    n_floor, n_wall = int(0.35 * N), int(0.30 * N)
    n_obj = N - n_floor - n_wall
    for b in range(B):
        k = min(int(rng.randint(num_boxes[0], num_boxes[1] + 1)), max_boxes)
        size = np.stack([rng.uniform(0.10, 0.25, k) * min(rx, ry),
                         rng.uniform(0.10, 0.25, k) * min(rx, ry),
                         rng.uniform(0.15, 0.50, k) * rz], 1)
        center = np.stack([size[:, 0] / 2 + rng.rand(k) * (rx - size[:, 0]),
                           size[:, 1] / 2 + rng.rand(k) * (ry - size[:, 1]),
                           size[:, 2] / 2], 1)
        cls = rng.randint(0, len(mean_size_arr), k)

        floor = np.stack([rng.rand(n_floor) * rx, rng.rand(n_floor) * ry,
                          np.zeros(n_floor)], 1)
        along, wall = rng.rand(n_wall), rng.randint(0, 4, n_wall)
        wx = np.where(wall < 2, along * rx, (wall == 3) * rx)
        wy = np.where(wall < 2, (wall == 1) * ry, along * ry)
        walls = np.stack([wx, wy, rng.rand(n_wall) * rz], 1)
        # a point on a box: two free coordinates in [-1/2, 1/2], the third
        # pinned to a face (0/1: x faces, 2/3: y faces, 4: the top)
        owner, face = rng.randint(0, k, n_obj), rng.randint(0, 5, n_obj)
        u = rng.rand(n_obj, 3) - 0.5
        axis, side = np.minimum(face // 2, 2), np.where(face % 2 == 0, 0.5, -0.5)
        side = np.where(face == 4, 0.5, side)
        u[np.arange(n_obj), axis] = side
        on_box = center[owner] + u * size[owner]

        pts = np.concatenate([floor, walls, on_box]).astype(np.float32)
        votes = np.zeros((N, 3), np.float32)
        votes[n_floor + n_wall:] = center[owner] - on_box
        order = rng.permutation(N)
        out["point_clouds"][b] = pts[order]
        out["vote_label"][b] = np.tile(votes[order], (1, 3))
        out["vote_label_mask"][b] = (order >= n_floor + n_wall).astype(np.int32)
        out["center_label"][b, :k] = center
        out["box_label_mask"][b, :k] = 1.0
        out["size_class_label"][b, :k] = cls
        out["size_residual_label"][b, :k] = size - mean_size_arr[cls]
        out["sem_cls_label"][b, :k] = cls
    return out


def make_detection_batch(B: int, N: int, rng: np.random.RandomState, device="cuda",
                         **kwargs) -> Dict[str, torch.Tensor]:
    """:func:`make_detection_arrays` as tensors on ``device``: the cloud under
    ``point_clouds`` [B, N, 3] and the detection labels."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev)
            for k, v in make_detection_arrays(B, N, rng, **kwargs).items()}
