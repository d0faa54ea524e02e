"""Metric writers and step profiling (port of
``situation3d_tpu/train/logging.py``): one ``MetricWriter`` facade over a
JSON-lines file plus, only if asked for and installed, TensorBoard and wandb;
``SmoothedValue`` / ``MetricLogger`` for windowed console metrics, whose
global averages ``synchronize_between_processes`` merges over the ranks of a
data-parallel run; ``StepProfiler`` over ``torch.profiler``.
"""
from __future__ import annotations

import collections
import datetime
import json
import logging
import os
import time
from typing import Dict, Iterable, Optional, Tuple

from situation3d_tpu_torch.parallel import collectives

_LOGGER = "situation3d_tpu_torch.metrics"


class MetricWriter:
    def __init__(self, log_dir: str, use_wandb: bool = False,
                 use_tensorboard: bool = False, project: str = "situation3d_tpu",
                 config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._logger = logging.getLogger(_LOGGER)
        self._wandb = None
        self._tb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project, config=config or {})
            except Exception:
                self._logger.warning("wandb unavailable; skipping")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._logger.warning("tensorboard unavailable; skipping")

    def write(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        flat = {f"{prefix}{k}": float(v) for k, v in metrics.items()
                if isinstance(v, (int, float))}
        self._jsonl.write(json.dumps({"step": step, **flat}) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(flat, step=step)
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)

    def write_image(self, tag: str, img, step: int) -> None:
        """Log a rendered image (uint8 HWC), the analogue of the reference's
        wandb image logging (``situation3d/utils/visualization.py:77-244``):
        always a PNG file under ``log_dir/images/``, and forwarded to wandb /
        TensorBoard when they are on."""
        import numpy as np

        from situation3d_tpu_torch.eval.visualization import write_png

        img = np.asarray(img, np.uint8)
        d = os.path.join(os.path.dirname(self._jsonl.name), "images")
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{tag.replace('/', '_')}_{step}.png"), img)
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Image(img)}, step=step)
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()


class SmoothedValue:
    """Windowed metric smoothing: a deque of the last ``window_size`` values
    plus global totals; median / avg over the window, global_avg, max and the
    latest value."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self) -> None:
        """Sum ``count`` and ``total`` over the ranks, so ``global_avg`` is
        the run's (the window stays this rank's)."""
        if collectives.world() == 1:
            return
        import torch
        both = collectives.psum(torch.tensor([self.count, self.total], dtype=torch.float64))
        self.count = int(both[0])
        self.total = float(both[1])

    @property
    def median(self) -> float:
        s = sorted(self.deque)
        return s[len(s) // 2] if s else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Named SmoothedValues + a ``log_every`` iterator that logs iteration
    and data time, the ETA and, on a card, the peak device memory."""

    def __init__(self, delimiter: str = "  ", window_size: int = 20):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            lambda: SmoothedValue(window_size))
        self.delimiter = delimiter
        self._logger = logging.getLogger(_LOGGER)

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name: str):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def synchronize_between_processes(self) -> None:
        for m in self.meters.values():
            m.synchronize_between_processes()

    def global_avg(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "") -> Iterable:
        import torch
        i = 0
        total = len(iterable) if hasattr(iterable, "__len__") else None
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = start
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                mem = (f" max mem: {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MB"
                       if torch.cuda.is_available() else "")
                if total:
                    eta = str(datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i))))
                    self._logger.info(
                        "%s [%d/%d] eta: %s %s time: %s data: %s%s", header, i,
                        total, eta, self, iter_time, data_time, mem)
                else:
                    self._logger.info("%s [%d] %s time: %s data: %s%s",
                                      header, i, self, iter_time, data_time, mem)
            i += 1
            end = time.time()
        self._logger.info("%s Total time: %s", header, str(
            datetime.timedelta(seconds=int(time.time() - start))))


class StepProfiler:
    """Starts a ``torch.profiler`` trace (CPU, and CUDA where there is a
    card) at step ``start`` and, at step ``stop``, writes it as a Chrome
    trace under ``log_dir``. ``(0, 0)`` or an empty window: off."""

    def __init__(self, log_dir: str, window: Tuple[int, int]):
        self.log_dir = log_dir
        self.start, self.stop = (int(w) for w in window)
        self._prof = None

    def maybe_toggle(self, step: int) -> None:
        if self.stop <= self.start:
            return
        if self._prof is None and step == self.start:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and step >= self.stop:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(
                self.log_dir, f"trace_steps_{self.start}_{self.stop}.json"))
            self._prof = None
