"""``ScannetDatasetConfig``: the 18 detection classes, the nyu40 mapping and
the angle / size class converters the detection loss and the box parser read.
The port's own copy of that class of the reference's
``data/scannet_preprocess.py`` (the scan readers there are not ported)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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
