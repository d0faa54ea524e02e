"""Farthest point sampling: the CUDA kernel's wrapper and its plain version.

Source note. Replaces the TPU kernel ``situation3d_tpu/ops/pallas/fps.py``
(``_fps_kernel`` / ``fps_pallas``) and is, for CUDA tensors, the reference's
``ops/pointnet2.py:furthest_point_sample`` (its optional ``valid`` mask
included): every sampling step of the PointNet++ / VoteNet path goes through
it. The algorithm is a chain of ``npoint - 1`` dependent steps, so on an H100
it is bound by the latency of a step (one pass over a row plus a block-wide
argmax), not by bytes or operations; ``csrc/fps.cu`` keeps one row's state
with one block for the whole launch (shared memory up to 8,192 points, L2
beyond) and spends one barrier a step. Farthest point sampling has no
gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from situation3d_tpu_torch.ops.cuda import _build

launches = 0   # +1 per kernel launch, nowhere else

SMEM_POINTS = 8192   # FPS_SMEM_POINTS of csrc/fps.cu: longer rows need the scratch
_BIG = 1e10


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
    global launches
    lib = _build.load_library()
    xyz = xyz.contiguous()
    mask = None if valid is None else valid.contiguous()
    scratch = (torch.empty(B, N, dtype=torch.float32, device=xyz.device)
               if N > SMEM_POINTS else None)
    with torch.cuda.device(xyz.device):
        code = lib.s3d_fps(xyz.data_ptr(), None if mask is None else mask.data_ptr(),
                           None if scratch is None else scratch.data_ptr(),
                           out.data_ptr(), B, N, int(npoint),
                           torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "fps")
    launches += 1
    return out
