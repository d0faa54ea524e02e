"""Farthest point sampling: the CUDA kernel's wrapper, its layout and its
plain version.

Source note. Replaces the TPU kernel ``situation3d_tpu/ops/pallas/fps.py``
(``_fps_kernel`` / ``fps_pallas``) and is, for CUDA tensors, the reference's
``ops/pointnet2.py:furthest_point_sample`` (its optional ``valid`` mask
included): every sampling step of the PointNet++ / VoteNet path goes through
it. The algorithm is a chain of ``npoint - 1`` dependent steps, so on an H100
it is bound by the latency of a step (one pass over the points an SM holds
plus an argmax that every holder of the row agrees on), not by bytes or
operations. ``csrc/fps.cu`` keeps each point's coordinates and running
minimum in registers for the whole launch; :func:`fps_layout` spreads a row
over one warp (N <= 512: no barrier), one block (N <= 8,192: one barrier a
step) or a thread-block cluster of 8 blocks on 8 SMs (longer rows: a block
barrier and a cluster barrier a step), the winner's coordinates travelling
with it through distributed shared memory. Rows longer than the registers of
a cluster hold (``MAX_POINTS``) keep the rest of their points' running minima
in a global scratch, read from L2 each step. Farthest point sampling has no
gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from situation3d_tpu_torch.ops.cuda import _build

launches = 0   # +1 per kernel launch, nowhere else

_BIG = 1e10
WARP_POINTS = 512       # rows up to this length: one warp a row
BLOCK_POINTS = 8192     # rows up to this length: one block a row
CLUSTER_BLOCKS = 8      # longer rows: a cluster of this many blocks (portable size)
MAX_THREADS = 1024
MAX_PPT = 8             # points a thread in the block and cluster modes (the aim:
                        # a step costs by the warps that take part, not the points)
WARP_PPTS = (1, 2, 4, 8, 16)
MAX_POINTS = CLUSTER_BLOCKS * MAX_THREADS * MAX_PPT   # 65,536 points a row in registers


class FpsLayout(NamedTuple):
    blocks_per_row: int     # 1, or CLUSTER_BLOCKS for a cluster a row
    threads: int            # a block; 32 = one warp a row
    points_per_thread: int  # held in registers


def _round32(n: int) -> int:
    return (n + 31) // 32 * 32


def fps_layout(n: int) -> FpsLayout:
    """How ``csrc/fps.cu`` spreads a row of ``n`` points: one warp
    (``n <= WARP_POINTS``), one block (``n <= BLOCK_POINTS``) or a cluster of
    ``CLUSTER_BLOCKS`` blocks, ``MAX_PPT`` points a thread in both (the
    fewest warps). Point ``c*T*P + k*T + t`` belongs to block ``c`` of the
    row, thread ``t``, register slot ``k``; above ``MAX_POINTS`` the layout
    is the largest cluster and the rest go to the scratch
    (:func:`fps_point_index`)."""
    if n < 1:
        raise ValueError(f"fps: a row holds no point (N = {n})")
    if n <= WARP_POINTS:
        ppt = next(k for k in WARP_PPTS if 32 * k >= n)
        return FpsLayout(1, 32, ppt)
    bpr = 1 if n <= BLOCK_POINTS else CLUSTER_BLOCKS
    per_block = -(-n // bpr)
    ppt = MAX_PPT
    threads = min(MAX_THREADS, _round32(-(-per_block // ppt)))
    return FpsLayout(bpr, threads, ppt)


def fps_point_index(n: int, layout: FpsLayout) -> np.ndarray:
    """int64 [blocks_per_row, slots, threads]: the point each (block, slot,
    thread) of ``layout`` holds, as ``csrc/fps.cu`` computes it, in the order
    a thread scans its slots; entries ``>= n`` are empty slots. The first
    ``points_per_thread`` slots are registers; a row longer than they hold
    adds scratch slots, point ``reg + m*c*t + block*t + thread``."""
    c, t, k = layout.blocks_per_row, layout.threads, layout.points_per_thread
    reg = c * t * k
    held = (np.arange(c)[:, None, None] * t * k + np.arange(k)[None, :, None] * t
            + np.arange(t)[None, None, :])
    m = -(-max(0, n - reg) // (c * t))
    spilled = (reg + np.arange(m)[None, :, None] * c * t
               + np.arange(c)[:, None, None] * t + np.arange(t)[None, None, :])
    return np.concatenate([held, spilled], axis=1)


def _check(xyz: torch.Tensor, npoint: int, valid: Optional[torch.Tensor]) -> None:
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps wants xyz [B, N, 3], got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"fps takes float32 coordinates, got {xyz.dtype}")
    if npoint < 1:
        raise ValueError(f"fps: npoint must be at least 1, got {npoint}")
    if xyz.shape[0] and xyz.shape[1] == 0:
        raise ValueError("fps: a row holds no point")
    if valid is not None:
        if valid.shape != xyz.shape[:2] or valid.dtype != torch.bool:
            raise ValueError(f"fps wants valid bool {tuple(xyz.shape[:2])}, got "
                             f"{valid.dtype} {tuple(valid.shape)}")
        if valid.device != xyz.device:
            raise ValueError("fps: xyz and valid must be on one device")


def fps_plain(xyz: torch.Tensor, npoint: int,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fps`: a loop of ``npoint - 1`` steps
    over ``[B, N]`` tensors. The distance is three products and two sums,
    each rounded (as the kernel writes it), and the argmax takes the lowest
    index among equal maxima explicitly."""
    _check(xyz, npoint, valid)
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    selectable = (x * x + y * y + z * z) > 1e-3
    if valid is not None:
        selectable = selectable & valid
    out = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    temp = torch.full((B, N), _BIG, dtype=xyz.dtype, device=xyz.device)
    arange = torch.arange(N, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    old = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        po = xyz[rows, old]                                       # [B, 3]
        dx, dy, dz = x - po[:, 0:1], y - po[:, 1:2], z - po[:, 2:3]
        temp = torch.minimum(temp, dx * dx + dy * dy + dz * dz)
        cand = torch.where(selectable, temp, -1.0)
        top = cand.amax(dim=1, keepdim=True)
        old = torch.where(cand == top, arange, N).amin(dim=1)     # lowest index on ties
        out[:, j] = old
    return out


def fps(xyz: torch.Tensor, npoint: int,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Iterative farthest point sampling: starts at index 0, then repeatedly
    takes the point with the largest running minimum distance to the chosen
    set; points with ``|p|^2 <= 1e-3`` (origin padding) and points where
    ``valid`` is False are never chosen after index 0. When nothing is left
    to choose, the lowest selectable index repeats (index 0 if there is none).

    Args:
      xyz: float32 [B, N, 3].
      npoint: number of samples, >= 1 (may exceed N).
      valid: optional bool [B, N].
    Returns int32 [B, npoint]. CPU tensors run the plain version; CUDA
    tensors launch the kernel (or raise).
    """
    _check(xyz, npoint, valid)
    if not xyz.is_cuda:
        return fps_plain(xyz, npoint, valid)
    B, N, _ = xyz.shape
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    if B == 0:
        return out
    bpr, threads, ppt = fps_layout(N)
    global launches
    lib = _build.load_library()
    xyz = xyz.contiguous()
    mask = None if valid is None else valid.contiguous()
    spill = (torch.empty(B, N - MAX_POINTS, dtype=torch.float32, device=xyz.device)
             if N > MAX_POINTS else None)
    with torch.cuda.device(xyz.device):
        code = lib.s3d_fps(xyz.data_ptr(), None if mask is None else mask.data_ptr(),
                           out.data_ptr(), None if spill is None else spill.data_ptr(),
                           B, N, int(npoint), bpr, threads, ppt,
                           torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "fps")
    launches += 1
    return out
