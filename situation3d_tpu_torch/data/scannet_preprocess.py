"""ScanNet preprocessing: raw scans -> per-scene arrays (the port's own copy
of ``situation3d_tpu/data/scannet_preprocess.py``): the label-map, axis
alignment, aggregation and segmentation readers, ``export_scene`` (per-vertex
semantic / instance labels and axis-aligned boxes) and
``ScannetDatasetConfig`` (the 18 detection classes, the nyu40 mapping and the
angle / size class converters the detection loss and the box parser read).
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def read_label_mapping(tsv_path: str, label_from: str = "raw_category",
                       label_to: str = "nyu40id") -> Dict[str, int]:
    """scannetv2-labels.combined.tsv reader (scannet_utils.read_label_mapping)."""
    mapping: Dict[str, int] = {}
    with open(tsv_path) as fh:
        for row in csv.DictReader(fh, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def read_axis_align_matrix(meta_path: str) -> np.ndarray:
    axis_align = np.eye(4)
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            for line in fh:
                if "axisAlignment" in line:
                    vals = [float(x) for x in
                            line.rstrip().strip("axisAlignment = ").split(" ")]
                    axis_align = np.array(vals).reshape(4, 4)
    return axis_align


def export_scene(
    vertices: np.ndarray,
    seg_to_verts: Dict[int, List[int]],
    object_id_to_segs: Dict[int, List[int]],
    object_id_to_label: Dict[int, int],
    axis_align_matrix: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Core of load_scannet_data.export: per-vertex semantic + instance
    labels and per-object axis-aligned bboxes from segmentation groups."""
    n = len(vertices)
    if axis_align_matrix is not None:
        pts = np.ones((n, 4))
        pts[:, :3] = vertices[:, :3]
        vertices = np.concatenate(
            [(pts @ axis_align_matrix.T)[:, :3], vertices[:, 3:]], axis=1)

    sem = np.zeros(n, np.int64)
    inst = np.zeros(n, np.int64)
    bboxes = []
    for obj_id, segs in object_id_to_segs.items():
        label = object_id_to_label.get(obj_id, 0)
        verts: List[int] = []
        for seg in segs:
            verts.extend(seg_to_verts.get(seg, []))
        verts_arr = np.asarray(verts, np.int64)
        sem[verts_arr] = label
        inst[verts_arr] = obj_id
        if len(verts_arr):
            pts = vertices[verts_arr, :3]
            mins, maxs = pts.min(0), pts.max(0)
            bboxes.append(np.concatenate(
                [(mins + maxs) / 2, maxs - mins, [label]]))
    return {
        "mesh_vertices": vertices.astype(np.float32),
        "semantic_labels": sem,
        "instance_labels": inst,
        "instance_bboxes": (np.stack(bboxes) if bboxes
                            else np.zeros((0, 7))).astype(np.float32),
    }


def load_aggregation(json_path: str) -> Tuple[Dict[int, List[int]], Dict[int, str]]:
    with open(json_path) as fh:
        data = json.load(fh)
    object_id_to_segs: Dict[int, List[int]] = {}
    object_id_to_name: Dict[int, str] = {}
    for group in data["segGroups"]:
        oid = group["objectId"] + 1  # instance ids are 1-indexed
        object_id_to_segs[oid] = group["segments"]
        object_id_to_name[oid] = group["label"]
    return object_id_to_segs, object_id_to_name


def load_segmentation(json_path: str) -> Dict[int, List[int]]:
    with open(json_path) as fh:
        data = json.load(fh)
    seg_to_verts: Dict[int, List[int]] = {}
    for v, seg in enumerate(data["segIndices"]):
        seg_to_verts.setdefault(seg, []).append(v)
    return seg_to_verts


class ScannetDatasetConfig:
    """18 detection classes + nyu40 mapping + angle / size converters."""

    def __init__(self, mean_size_arr: Optional[np.ndarray] = None):
        self.num_class = 18
        self.num_heading_bin = 1
        self.num_size_cluster = 18
        self.type2class = {
            "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4,
            "door": 5, "window": 6, "bookshelf": 7, "picture": 8,
            "counter": 9, "desk": 10, "curtain": 11, "refrigerator": 12,
            "showercurtrain": 13, "toilet": 14, "sink": 15, "bathtub": 16,
            "garbagebin": 17}
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.nyu40ids = np.array(
            [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
        self.nyu40id2class = {int(n): i for i, n in enumerate(self.nyu40ids)}
        self.mean_size_arr = (mean_size_arr if mean_size_arr is not None
                              else np.ones((18, 3), np.float32))

    def angle2class(self, angle: float) -> Tuple[int, float]:
        """ScanNet boxes are axis-aligned: single heading bin, residual = angle."""
        return 0, float(angle)

    def class2angle(self, cls: int, residual: float) -> float:
        return float(residual)

    def size2class(self, size: np.ndarray, type_name: str) -> Tuple[int, np.ndarray]:
        cls = self.type2class[type_name]
        return cls, size - self.mean_size_arr[cls]

    def class2size(self, cls: int, residual: np.ndarray) -> np.ndarray:
        return self.mean_size_arr[cls] + residual
