"""YAML-driven dataset builders, LAVIS ``build_info`` style (port of
``situation3d_tpu/data/builders.py``).

A dataset yaml names per-split annotation files and a scene-feature storage
root under ``build_info``; relative storage paths resolve against a cache
root (``get_cache_path``). Nothing is downloaded: a missing storage path
warns. ``yaml`` is imported only where a file is read
(``load_dataset_config``; without it a JSON file is read), and
``ThreeDVQABuilder`` runs from the equivalent dict as well.

Yaml shape (that of ``lavis/configs/datasets/3dvqa/defaults.yaml``):

    datasets:
      3d_vqa:
        data_type: features
        build_info:
          annotations:
            train: {storage: [sqa3d/annotations/SQA_train.json]}
            val:   {storage: [sqa3d/annotations/SQA_val.json]}
          features:
            storage: sqa3d/features/
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, List, Optional

from situation3d_tpu_torch.config import Config
from situation3d_tpu_torch.data.threedvqa import ThreeDVQADataset
from situation3d_tpu_torch.utils.registry import registry


def get_cache_path(rel: str, cache_root: Optional[str] = None) -> str:
    """Resolve a storage path: absolute and ``./``-relative pass through,
    otherwise join the cache root (base_dataset_builder.py:171-190)."""
    if os.path.isabs(rel) or rel.startswith("."):
        return rel
    root = cache_root or os.environ.get("SITUATION3D_CACHE_ROOT",
                                        "assets/cache")
    return os.path.join(root, rel)


def load_dataset_config(cfg_path: str) -> Dict[str, Any]:
    """First (only) entry under ``datasets:``
    (base_dataset_builder.py:215-219). Without the ``yaml`` package a file
    written as JSON (a subset of YAML) is still read."""
    try:
        import yaml  # only needed to read a file
    except ImportError:
        yaml = None
    with open(cfg_path) as fh:
        data = yaml.safe_load(fh) if yaml is not None else json.load(fh)
    dsets = data["datasets"]
    name = next(iter(dsets))
    return {"name": name, **(dsets[name] or {})}


class BaseDatasetBuilder:
    """Resolves build_info storage paths and constructs per-split datasets.

    Subclasses set ``data_type`` and implement ``make_dataset(split,
    ann_paths, vis_path, is_train)``.
    """
    data_type = "features"

    def __init__(self, cfg: Config, dataset_cfg: Dict[str, Any],
                 cache_root: Optional[str] = None):
        self.cfg = cfg
        self.dataset_cfg = dataset_cfg
        self.cache_root = cache_root
        self.data_type = dataset_cfg.get("data_type", self.data_type)

    def build(self) -> Dict[str, Any]:
        info = self.dataset_cfg.get("build_info", {})
        ann_info = info.get("annotations", {})
        vis_info = info.get(self.data_type, {})
        vis_path = vis_info.get("storage")
        if vis_path is not None:
            vis_path = get_cache_path(vis_path, self.cache_root)
            if not os.path.exists(vis_path):
                warnings.warn(f"storage path {vis_path} does not exist.")
        datasets: Dict[str, Any] = {}
        for split, entry in ann_info.items():
            if split not in ("train", "val", "test"):
                continue
            storage = entry.get("storage", [])
            if isinstance(storage, str):
                storage = [storage]
            ann_paths = [get_cache_path(p, self.cache_root) for p in storage]
            datasets[split] = self.make_dataset(
                split, ann_paths, vis_path, is_train=(split == "train"))
        return datasets

    def make_dataset(self, split: str, ann_paths: List[str],
                     vis_path: Optional[str], is_train: bool):
        raise NotImplementedError


@registry.register("builder", "3d_vqa")
class ThreeDVQABuilder(BaseDatasetBuilder):
    """3D-VQA over precomputed scene features (vqa_builder.py:14-17);
    annotation JSONs may be a list — records concatenate (``ann_paths``
    semantics of threedvqa_datasets.py:37-44)."""
    data_type = "features"

    def make_dataset(self, split, ann_paths, vis_path, is_train):
        records: List[dict] = []
        for p in ann_paths:
            with open(p) as fh:
                data = json.load(fh)
            records.extend(data if isinstance(data, list)
                           else data.get("annotations", data.get("data", [])))
        return ThreeDVQADataset(self.cfg.blip2, records,
                                feature_dir=vis_path)


def build_datasets_from_yaml(cfg: Config, cfg_path: str,
                             cache_root: Optional[str] = None
                             ) -> Dict[str, Any]:
    """One-call equivalent of ``task.build_datasets`` through the yaml
    builder registry."""
    ds_cfg = load_dataset_config(cfg_path)
    builder_cls = registry.get("builder", ds_cfg["name"])
    return builder_cls(cfg, ds_cfg, cache_root=cache_root).build()
