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

from situation3d_tpu_torch.ckpt_compat.from_jax import load_jax_variables, reference_paths

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
    """Write only the trainable parameters to an ``.npz`` keyed by the JAX
    package's '/'-joined tree path, in its layouts (``Dense`` kernels
    [in, out]: ``ckpt_compat/from_jax.py:reference_paths``): the file the
    reference writes, so either package reads it. Returns the number of
    tensors saved."""
    paths = reference_paths(model)
    flat = {}
    for n, p in model.named_parameters():
        if trainable[n]:
            tree_path, transpose = paths[n]
            value = p.detach().float().cpu().numpy()
            flat["/".join(tree_path)] = value.T if transpose else value
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return len(flat)


def load_npz_tree(path: str) -> Dict[str, Any]:
    """A '/'-keyed ``.npz`` as the nested tree of arrays it flattens."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return tree


def load_trainable_npz(path: str, model: torch.nn.Module) -> int:
    """Merge a trainable-only ``.npz`` (``save_trainable_npz``'s, or the
    reference's) back over a full model (frozen weights keep their values).
    Raises ``ValueError`` on a shape mismatch and ``KeyError`` on a key the
    model does not hold. Returns the number of tensors merged."""
    with np.load(path) as data:
        n = len(data.files)
    unused = load_jax_variables(model, load_npz_tree(path), {}, partial=True)
    if unused:
        raise KeyError(f"unmatched checkpoint keys: {unused[:5]}")
    return n
