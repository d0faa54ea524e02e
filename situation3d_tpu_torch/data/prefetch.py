"""Input-pipeline prefetching (port of ``situation3d_tpu/data/prefetch.py``,
which replaces the reference's DataLoader worker processes + CUDA-stream
PrefetchLoader, ``lavis/datasets/datasets/dataloader_utils.py:15-160``): a
background-thread prefetcher that keeps N batches ready (loading,
augmentation, voxelization and the host plans run there, beside the
device's work), a wrapper that attaches host-built UNet plans to each batch,
and the ratio-weighted mix of several loaders.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np

from situation3d_tpu_torch.data.sqa3d import batch_iterator
from situation3d_tpu_torch.sparse.host_plan import build_host_plan


class ThreadPrefetcher:
    """Wrap an iterator; pull items on a background thread."""

    def __init__(self, it: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._done:
                if self._err is not None:
                    raise self._err
                return
            yield item


def attach_host_plans(batches: Iterable[Dict[str, np.ndarray]],
                      capacities: Sequence[int]
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Attach a host-built UNet plan (sparse/host_plan.py) to each batch so
    the model skips its plan build on the device."""
    for batch in batches:
        batch = dict(batch)
        batch["plan"] = build_host_plan(
            batch["voxel_coords"], batch["voxel_mask"], capacities)
        yield batch


def make_train_pipeline(dataset, batch_size: int, capacities=None,
                        seed: int = 0, epochs=None, prefetch_depth: int = 2):
    """batch_iterator -> optional host plans -> thread prefetch."""
    it: Iterable = batch_iterator(dataset, batch_size, shuffle=True,
                                  seed=seed, epochs=epochs)
    if capacities is not None:
        it = attach_host_plans(it, capacities)
    return ThreadPrefetcher(it, prefetch_depth)


class MultiIterLoader:
    """Ratio-weighted sampling from several infinite iterators
    (``dataloader_utils.MultiIterLoader:15-60``): the joint SQA3D + ScanQA
    training mix."""

    def __init__(self, loaders, ratios=None, seed: int = 0):
        self.loaders = [iter(l) for l in loaders]
        n = len(loaders)
        ratios = list(ratios) if ratios is not None else [1.0] * n
        total = sum(ratios)
        self.probs = [r / total for r in ratios]
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        return self

    def __next__(self):
        i = self.rng.choice(len(self.loaders), p=self.probs)
        return next(self.loaders[i])


def repeat_iterator(make_iter: Callable[[], Iterable]):
    """Infinite restartable iterator (dataloader_utils.IterLoader)."""
    while True:
        yield from make_iter()
