"""Misc utilities (port of ``situation3d_tpu/utils/misc.py``): seeding,
parameter counting, ETA formatting and a stream logger.
``SmoothedValue`` and ``MetricLogger`` are the port's
``train/logging.py`` classes, re-exported here under their reference path.
"""
from __future__ import annotations

import datetime
import logging
import random
import sys

import numpy as np
import torch
from torch import nn

from situation3d_tpu_torch.train.logging import MetricLogger, SmoothedValue  # noqa: F401


def set_seed(seed: int) -> None:
    """Seed Python's ``random``, numpy's global generator and torch's
    (train.py:419-425). The port's device randomness also comes from
    explicit ``torch.Generator`` objects the trainer seeds."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def decode_eta(seconds: float) -> str:
    """h:mm:ss ETA string (utils/eta.py:19)."""
    return str(datetime.timedelta(seconds=int(seconds)))


def setup_logger(name: str = "situation3d_tpu_torch",
                 level: int = logging.INFO) -> logging.Logger:
    """Plain stream logger on stdout (lavis setup_logger analogue)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger
