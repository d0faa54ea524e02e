"""OpenScene per-scene loaders: 3D points and fused 2D features (the port's
own copy of ``situation3d_tpu/data/openscene_loader.py``).

``Point3DLoader`` and ``FusedFeatureLoader`` read ScanNet-style ``.pth``
scenes (``(locs, feats, labels)`` tuples) and precomputed 2D-fused CLIP
features (``{scene}_{k}.pt`` dicts with ``feat`` / ``mask_full``), the
inputs of open-vocabulary segmentation. Each item is a fixed-capacity
padded dict with masks (``overflow`` counts the voxels past the capacity);
``-100`` labels become 255 and colours ``(feats + 1) * 127.5``; scenes are
cached in-process; augmentation is ``data/augmentation.py`` drawing from
the loader's ``RandomState``, in the reference's order, so one seed gives
the same items in both packages.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

import torch

from situation3d_tpu_torch.data import augmentation as aug
from situation3d_tpu_torch.ops.voxelize import voxelize_np

IGNORE_LABEL = 255


def _load_scene(path: str):
    locs, feats, labels = torch.load(path, map_location="cpu",
                                     weights_only=False)
    labels = np.asarray(labels).copy()
    labels[labels == -100] = IGNORE_LABEL          # point_loader.py:122
    return (np.asarray(locs, np.float32),
            (np.asarray(feats, np.float32) + 1.0) * 127.5,   # :124
            labels.astype(np.uint8))


class Point3DLoader:
    """3D points + labels -> fixed-shape voxelized samples.

    Returns per item: ``coords [cap,3] int32, feats [cap,3] float32 (all
    ones unless input_color, point_loader.py:135-137), labels [cap] int32,
    mask [cap] bool`` and, when ``eval_all``, the full-resolution
    ``point_labels``/``inds_reconstruct`` for voxel->point upscoring
    (point_loader.py:138-141)."""

    def __init__(self, datapath_prefix: str, voxel_size: float = 0.05,
                 split: str = "train", aug_enabled: bool = False,
                 loop: int = 1, eval_all: bool = False,
                 input_color: bool = False, capacity: int = 49152,
                 point_capacity: int = 196608, seed: int = 0,
                 cache_scenes: bool = True):
        pattern = os.path.join(datapath_prefix, split or "", "*.pth")
        self.data_paths: List[str] = sorted(glob.glob(pattern))
        if not self.data_paths:
            raise FileNotFoundError(
                f"0 files matched {pattern} (point loader)")
        self.voxel_size = voxel_size
        self.split = split
        self.aug = aug_enabled
        self.loop = loop
        self.eval_all = eval_all
        self.input_color = input_color
        self.capacity = capacity
        self.point_capacity = point_capacity
        self.rng = np.random.RandomState(seed)
        self._cache: Optional[Dict[str, tuple]] = {} if cache_scenes else None

    def __len__(self) -> int:
        return len(self.data_paths) * self.loop

    def _scene(self, path: str):
        if self._cache is not None and path in self._cache:
            return self._cache[path]
        data = _load_scene(path)
        if self._cache is not None:
            self._cache[path] = data
        return data

    def _augment_pre(self, locs: np.ndarray) -> np.ndarray:
        # ElasticDistortion((0.2,0.4),(0.8,1.6)) (point_loader.py:103-105)
        for gran, mag in ((0.2, 0.4), (0.8, 1.6)):
            locs = aug.elastic_distortion(locs, self.rng, gran, mag)
        return locs

    def _augment_input(self, locs, colors):
        locs = aug.random_horizontal_flip(locs, self.rng, upright_axis=2)
        colors = aug.chromatic_auto_contrast(colors, self.rng)
        colors = aug.chromatic_translation(colors, self.rng, 0.1)
        colors = aug.chromatic_jitter(colors, self.rng, 0.05)
        colors = aug.hue_saturation_translation(colors, self.rng, 0.5, 0.2)
        return locs, colors

    def _fixed(self, arr: np.ndarray, cap: int, fill=0):
        out = np.full((cap,) + arr.shape[1:], fill, arr.dtype)
        n = min(len(arr), cap)
        out[:n] = arr[:n]
        return out, n

    def __getitem__(self, index_long: int) -> Dict[str, np.ndarray]:
        index = index_long % len(self.data_paths)
        locs_in, colors_in, labels_in = self._scene(self.data_paths[index])
        locs = self._augment_pre(locs_in) if self.aug else locs_in
        vox_coords, first_index, inverse = voxelize_np(locs, self.voxel_size)
        vox_colors = colors_in[first_index]
        vox_labels = labels_in[first_index].astype(np.int32)
        if self.aug:
            vox_coords_f, vox_colors = self._augment_input(
                vox_coords.astype(np.float32), vox_colors)
            vox_coords = vox_coords_f.astype(np.int32)
        feats = (vox_colors / 127.5 - 1.0 if self.input_color
                 else np.ones((len(vox_coords), 3), np.float32))
        coords, n = self._fixed(vox_coords.astype(np.int32), self.capacity)
        feats, _ = self._fixed(feats.astype(np.float32), self.capacity)
        labels, _ = self._fixed(vox_labels, self.capacity, IGNORE_LABEL)
        mask = np.zeros(self.capacity, bool)
        mask[:n] = True
        item = {"coords": coords, "feats": feats, "labels": labels,
                "mask": mask,
                "overflow": np.int32(max(len(vox_coords) - self.capacity, 0))}
        if self.eval_all:
            pl, np_ = self._fixed(labels_in.astype(np.int32),
                                  self.point_capacity, IGNORE_LABEL)
            ir, _ = self._fixed(inverse.astype(np.int32), self.point_capacity)
            pm = np.zeros(self.point_capacity, bool)
            pm[:np_] = True
            item.update(point_labels=pl, inds_reconstruct=ir, point_mask=pm)
        return item


class FusedFeatureLoader(Point3DLoader):
    """Adds per-scene fused 2D features (feature_loader.py:12-145): each
    scene has ``n_occur`` feature files ``{scene}_{k}.pt`` holding ``feat``
    [M, D] over the points selected by ``mask_full`` [N]; train picks a
    random occurrence, eval scatters features back to full resolution and
    scores every point (feature_loader.py:88-93)."""

    def __init__(self, datapath_prefix: str, datapath_prefix_feat: str,
                 **kw):
        super().__init__(datapath_prefix, **kw)
        self.datapath_feat = datapath_prefix_feat
        self.list_occur = []
        keep_paths = []
        for p in self.data_paths:
            scene = os.path.basename(p)
            scene = scene[:-15] if scene.endswith("_vh_clean_2.pth") \
                else scene[:-4]
            n = len(glob.glob(os.path.join(datapath_prefix_feat,
                                           scene + "_*.pt")))
            if n:   # scenes with no features drop (feature_loader.py:48-56)
                keep_paths.append(p)
                self.list_occur.append(n)
        if not keep_paths:
            raise FileNotFoundError(
                f"0 feature files under {datapath_prefix_feat}")
        self.data_paths = keep_paths

    def _scene_name(self, path: str) -> str:
        base = os.path.basename(path)
        return base[:-15] if base.endswith("_vh_clean_2.pth") else base[:-4]

    def __getitem__(self, index_long: int) -> Dict[str, np.ndarray]:
        index = index_long % len(self.data_paths)
        path = self.data_paths[index]
        locs_in, colors_in, labels_in = self._scene(path)
        k = self.rng.randint(self.list_occur[index]) \
            if self.list_occur[index] > 1 else 0
        blob = torch.load(os.path.join(
            self.datapath_feat, f"{self._scene_name(path)}_{k}.pt"),
            map_location="cpu", weights_only=False)
        feat_3d = np.asarray(blob["feat"], np.float32)
        if feat_3d.ndim > 2:
            feat_3d = feat_3d[..., 0]
        mask_chunk = np.asarray(blob["mask_full"], bool)

        if self.split != "train":
            # eval: every point scored; scatter features to full resolution
            full = np.zeros((len(locs_in), feat_3d.shape[1]), np.float32)
            full[mask_chunk] = feat_3d
            feat_3d, point_sel = full, np.ones(len(locs_in), bool)
        else:
            point_sel = mask_chunk

        locs = self._augment_pre(locs_in) if self.aug else locs_in
        vox_coords, first_index, inverse = voxelize_np(locs, self.voxel_size)
        vox_labels = labels_in[first_index].astype(np.int32)
        vis = point_sel[first_index]                 # voxel visibility mask
        if self.split == "train":
            # features exist only for visible points: map each visible
            # voxel's representative point into feat_3d row order
            # (feature_loader.py:103-122, the index1/index3 construction)
            order = np.cumsum(mask_chunk) - 1
            rows = order[first_index[vis]]
            gath = feat_3d[rows]
            vfeat = np.zeros((len(vox_coords), feat_3d.shape[1]), np.float32)
            vfeat[vis] = gath
        else:
            vfeat = feat_3d[first_index]

        D = vfeat.shape[1]
        coords, n = self._fixed(vox_coords.astype(np.int32), self.capacity)
        feats3d, _ = self._fixed(vfeat, self.capacity)
        labels, _ = self._fixed(vox_labels, self.capacity, IGNORE_LABEL)
        vism, _ = self._fixed(vis, self.capacity, False)
        mask = np.zeros(self.capacity, bool)
        mask[:n] = True
        colors = (colors_in[first_index] / 127.5 - 1.0 if self.input_color
                  else np.ones((len(vox_coords), 3), np.float32))
        cfeats, _ = self._fixed(colors.astype(np.float32), self.capacity)
        item = {"coords": coords, "feats": cfeats, "feat_3d": feats3d,
                "labels": labels, "mask": mask, "feat_mask": vism,
                "overflow": np.int32(max(len(vox_coords) - self.capacity, 0))}
        if self.eval_all:
            pl, np_ = self._fixed(labels_in.astype(np.int32),
                                  self.point_capacity, IGNORE_LABEL)
            ir, _ = self._fixed(inverse.astype(np.int32), self.point_capacity)
            pm = np.zeros(self.point_capacity, bool)
            pm[:np_] = True
            item.update(point_labels=pl, inds_reconstruct=ir, point_mask=pm)
        return item
