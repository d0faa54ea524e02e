"""Checkpoint save / restore over ``torch.save`` (port of
``situation3d_tpu/train/checkpoint.py``): one file per step under a
directory, keep-last-N, per-step metrics for "best" bookkeeping, and
trainable-only ``.npz`` files.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """``save(step, state, metrics)`` writes ``step_<n>.pt`` atomically and
    prunes to the newest ``keep`` steps; with ``best_metric`` set, the best
    step by that metric is never pruned. ``state`` is any picklable tree of
    tensors (the trainer passes ``TrainState.state_dict()``)."""

    def __init__(self, directory: str, keep: int = 3,
                 best_metric: Optional[str] = None, best_mode: str = "max"):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep
        self._best_metric = best_metric
        self._sign = 1.0 if best_mode == "max" else -1.0
        self._metrics_path = os.path.join(self._dir, "metrics.json")

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        steps = [int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self._dir)) if m]
        return sorted(steps)

    def _read_metrics(self) -> Dict[str, dict]:
        if not os.path.exists(self._metrics_path):
            return {}
        with open(self._metrics_path) as fh:
            return json.load(fh)

    def _write_metrics(self, table: Dict[str, dict]) -> None:
        with open(self._metrics_path + ".tmp", "w") as fh:
            json.dump(table, fh)
        os.replace(self._metrics_path + ".tmp", self._metrics_path)

    def metrics(self, step: int) -> Optional[dict]:
        return self._read_metrics().get(str(step))

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        table = self._read_metrics()
        if metrics:
            table[str(step)] = {k: float(v) for k, v in metrics.items()}
        self._write_metrics(table)
        steps = self.all_steps()
        protect = {self.best_step()} if self._best_metric else set()
        for old in steps[:-self._keep] if self._keep > 0 else []:
            if old not in protect:
                os.remove(self._path(old))
                table.pop(str(old), None)
        self._write_metrics(table)

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Any:
        """The saved state of ``step`` (the latest without one), or None when
        the directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=False)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self, metric: Optional[str] = None) -> Optional[int]:
        """Step of the retained checkpoint with the best ``metric``."""
        metric = metric or self._best_metric
        best, best_val = None, None
        table = self._read_metrics()
        for step in self.all_steps():
            m = table.get(str(step))
            if not m or metric not in m:
                continue
            v = self._sign * float(m[metric])
            if best_val is None or v > best_val:
                best, best_val = step, v
        return best


def save_trainable_npz(path: str, model: torch.nn.Module,
                       trainable: Dict[str, bool]) -> int:
    """Write only the trainable parameters to an ``.npz`` keyed by the
    '/'-joined parameter path. Returns the number of tensors saved."""
    flat = {n.replace(".", "/"): p.detach().float().cpu().numpy()
            for n, p in model.named_parameters() if trainable[n]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return len(flat)


def load_trainable_npz(path: str, model: torch.nn.Module) -> int:
    """Merge a trainable-only ``.npz`` back over a full model (frozen weights
    keep their values). Raises on a shape mismatch or an unmatched key."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            new = flat.pop(name.replace(".", "/"), None)
            if new is None:
                continue
            if tuple(new.shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint {new.shape} vs model {tuple(p.shape)}")
            p.copy_(torch.from_numpy(new).to(p.dtype))
            n += 1
    if flat:
        raise KeyError(f"unmatched checkpoint keys: {sorted(flat)[:5]}")
    return n
