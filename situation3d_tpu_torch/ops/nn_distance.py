"""Chamfer-style nearest-neighbour distance and the huber loss: the port of
the reference's ``ops/nn_distance.py``. Plain PyTorch."""
from __future__ import annotations

from typing import Tuple

import torch


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_err = error.abs()
    quad = abs_err.clamp(max=delta)
    lin = abs_err - quad
    return 0.5 * quad ** 2 + delta * lin


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1smooth: bool = False,
                delta: float = 1.0, l1: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Args: pc1 [B, N, C], pc2 [B, M, C].

    Returns (dist1 [B, N], idx1 int32 [B, N], dist2 [B, M], idx2 int32 [B, M]):
    the summed per-coordinate squared (or l1 / huber) distance to the nearest
    point on the other side, and which point that is (the first among equal
    minima).
    """
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]               # [B, N, M, C]
    if l1smooth:
        d = huber_loss(diff, delta).sum(-1)
    elif l1:
        d = diff.abs().sum(-1)
    else:
        d = (diff ** 2).sum(-1)
    dist1, idx1 = d.min(dim=2)
    dist2, idx2 = d.min(dim=1)
    return dist1, idx1.to(torch.int32), dist2, idx2.to(torch.int32)
