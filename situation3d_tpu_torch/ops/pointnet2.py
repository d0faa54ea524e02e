"""PointNet++ point-cloud ops: the port of the reference's ``ops/pointnet2.py``.

Layout is channel-last ``[B, N, C]`` as there. Farthest point sampling is the
hand-written CUDA kernel (``ops/cuda/fps.py``); the other ops are plain
PyTorch, as they are plain XLA in the reference. The three gathers
(``gather_points``, ``group_points`` and the one inside
``three_interpolate``) go through ``GatherRows``, whose backward is the
deterministic ``scatter_add_rows`` kernel (``torch.gather``'s backward on a
CUDA device adds with float atomics).

Pairwise distances keep the reference's expanded form
``|a|^2 - 2ab + |b|^2`` clamped at 0, with the product written as three
elementwise multiplies and two adds: float32 by construction whatever the
process-wide matmul precision is, and the same roundings on the CPU and on a
CUDA device, so radius tests fall the same way on both. A ``[B, M, N]``
distance block never exists whole: centres are processed in chunks that keep
one such block under ``PAIRWISE_CHUNK_BYTES``.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from situation3d_tpu_torch.ops.cuda.fps import fps as furthest_point_sample  # noqa: F401
from situation3d_tpu_torch.ops.cuda.gather_rows import GatherRows

_BIG = 1e10
PAIRWISE_CHUNK_BYTES = 256 * 2 ** 20   # one float32 [B, m, N] block of a chunk


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a_x b_x + a_y b_y + a_z b_z`` of broadcastable [..., 3, ...] slices
    given as 3-tuples: two sums in a fixed order, each product rounded."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance [..., M, N] between a [..., M, 3] and
    b [..., N, 3], expanded form, clamped at 0."""
    ac = a.split(1, dim=-1)                                      # 3 x [..., M, 1]
    bc = b.transpose(-1, -2).split(1, dim=-2)                    # 3 x [..., 1, N]
    d = _dot3(ac, ac) - 2.0 * _dot3(ac, bc) + _dot3(bc, bc)
    return d.clamp(min=0.0)


def _center_chunks(B: int, M: int, N: int) -> Iterator[slice]:
    step = max(1, PAIRWISE_CHUNK_BYTES // max(1, 4 * B * N))
    for m0 in range(0, M, step):
        yield slice(m0, min(M, m0 + step))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, m, :] = points[b, idx[b, m], :]``.

    Args: points [B, N, C] float; idx [B, M] int. Returns [B, M, C].
    """
    return GatherRows.apply(points, idx.to(torch.int32))


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Radius neighbourhood query: for each centre the first ``nsample``
    points (in index order) with squared distance ``< radius^2``; slots beyond
    the hit count repeat the first hit; a centre with no hit returns index 0.

    Args:
      xyz: [B, N, 3] points; new_xyz: [B, M, 3] centres;
      valid: optional bool [B, N] excluding padded points.
    Returns int32 [B, M, K] indices into N (K = ``min(nsample, N)``).
    """
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    k = min(nsample, N)
    arange = torch.arange(N, dtype=torch.int32, device=xyz.device)
    slot = torch.arange(k, dtype=torch.int32, device=xyz.device)
    out = torch.empty(B, M, k, dtype=torch.int32, device=xyz.device)
    with torch.no_grad():
        for ms in _center_chunks(B, M, N):
            within = _pairwise_sqdist(new_xyz[:, ms], xyz) < radius * radius
            if valid is not None:
                within &= valid[:, None, :]
            keys = torch.where(within, arange, N)
            hits = keys.topk(k, dim=-1, largest=False, sorted=True).values
            cnt = within.sum(-1, keepdim=True)
            first = torch.where(cnt > 0, hits[..., :1].clamp(0, N - 1), 0)
            out[:, ms] = torch.where(slot < cnt, hits, first)
    return out


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, m, k, :] = points[b, idx[b, m, k], :]``.

    Args: points [B, N, C]; idx [B, M, K]. Returns [B, M, K, C].
    """
    B, M, K = idx.shape
    flat = idx.reshape(B, M * K).to(torch.int32)
    return GatherRows.apply(points, flat).view(B, M, K, points.shape[-1])


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             known_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest neighbours of each ``unknown`` point among ``known``,
    nearest first; euclidean (not squared) distances. The order among equal
    distances is unspecified.

    Args: unknown [B, N, 3]; known [B, M, 3]; known_valid optional [B, M].
    Returns: dist [B, N, 3], idx int32 [B, N, 3].
    """
    dists, idxs = [], []
    for ns in _center_chunks(unknown.shape[0], unknown.shape[1], known.shape[1]):
        d2 = _pairwise_sqdist(unknown[:, ns], known)
        if known_valid is not None:
            d2 = torch.where(known_valid[:, None, :], d2, _BIG)
        top, i = d2.topk(3, dim=-1, largest=False, sorted=True)
        dists.append(top.clamp(min=0.0).sqrt())
        idxs.append(i.to(torch.int32))
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """``out[b, n, :] = sum_k weight[b, n, k] * feats[b, idx[b, n, k], :]``.

    Args: feats [B, M, C]; idx [B, N, 3]; weight [B, N, 3]. Returns [B, N, C].
    """
    gathered = group_points(feats, idx)                          # [B, N, 3, C]
    return (gathered * weight[..., None]).sum(dim=2)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights of the feature-propagation module."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(-1, keepdim=True)
