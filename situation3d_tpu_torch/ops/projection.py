"""2D -> 3D feature back-projection, the multiview path (port of
``situation3d_tpu/ops/projection.py``): project points through a camera,
keep those inside the frustum whose depth agrees with the depth map, gather
each kept point's image features, and fuse the views.

The per-view gather is ``ops/cuda/gather_rows.py:GatherRows`` on the
``[H*W, C]`` table of each view, all views in one launch: on the card the
gather kernel, and its backward the deterministic ``scatter_add_rows`` into
the feature maps (no float atomics; two backward passes are bit-equal). CPU
tensors take the plain versions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from situation3d_tpu_torch.ops.cuda.gather_rows import GatherRows

# float32 values that convert to int32 without overflow: larger ones stand
# for pixels far outside the image, as the reference's saturating conversion
# makes them
_PIXEL_BOUND = 2.0 ** 30


class CameraIntrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


def project_points(
    points: torch.Tensor,
    world2cam: torch.Tensor,
    intr: CameraIntrinsics,
    image_hw: Tuple[int, int],
    depth: Optional[torch.Tensor] = None,
    depth_min: float = 0.1,
    depth_max: float = 8.0,
    depth_thresh: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point -> pixel correspondence with frustum and depth-consistency tests.

    Args:
      points: [N, 3] world coords; world2cam: [4, 4]; image_hw: (H, W);
      depth: optional [H, W] depth map for the occlusion test, read at the
        clipped pixel.

    Returns (pix int32 [N, 2] (row, col), clipped to the image; valid bool
    [N]). Pixels are ``round`` (half to even) of the projection; a zero
    depth divides as ``1e-6``.
    """
    H, W = image_hw
    ones = torch.ones_like(points[:, :1])
    cam = (torch.cat([points, ones], -1) @ world2cam.T)[:, :3]
    z = cam[:, 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-6), z)
    u = intr.fx * cam[:, 0] / zs + intr.cx
    v = intr.fy * cam[:, 1] / zs + intr.cy
    col = torch.round(u).clamp(-_PIXEL_BOUND, _PIXEL_BOUND).to(torch.int32)
    row = torch.round(v).clamp(-_PIXEL_BOUND, _PIXEL_BOUND).to(torch.int32)
    valid = ((z > depth_min) & (z < depth_max)
             & (col >= 0) & (col < W) & (row >= 0) & (row < H))
    rc, cc = row.clamp(0, H - 1), col.clamp(0, W - 1)
    if depth is not None:
        d = depth[rc.long(), cc.long()]
        valid = valid & ((d - z).abs() <= depth_thresh) & (d > 0)
    return torch.stack([rc, cc], -1), valid


def _gather_views(feats2d: torch.Tensor, pix: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """``feats2d [V, H, W, C]``, ``pix [V, N, 2]``, ``valid [V, N]`` ->
    ``[V, N, C]``, zero where not valid."""
    V, H, W, C = feats2d.shape
    flat = (pix[..., 0] * W + pix[..., 1]).to(torch.int32)
    gathered = GatherRows.apply(feats2d.reshape(V, H * W, C), flat)
    return torch.where(valid[..., None], gathered, torch.zeros_like(gathered))


def backproject_features(feat2d: torch.Tensor, pix: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Gather image features onto points; invalid points get zeros.

    Args: feat2d [H, W, C]; pix int32 [N, 2]; valid bool [N]. Returns [N, C];
    differentiable into ``feat2d`` by a deterministic scatter-add.
    """
    return _gather_views(feat2d[None], pix[None], valid[None])[0]


def multiview_backproject(
    points: torch.Tensor,
    feats2d: torch.Tensor,
    world2cams: torch.Tensor,
    intr: CameraIntrinsics,
    depths: Optional[torch.Tensor] = None,
    reduce: str = "mean",
) -> torch.Tensor:
    """Fuse V views onto one point cloud (ScanRefer-style multiview features).

    Args: points [N, 3]; feats2d [V, H, W, C]; world2cams [V, 4, 4]; depths
    optional [V, H, W]. Returns [N, C]: with ``reduce="mean"`` the mean over
    the views that see a point (zero where none does), otherwise the
    largest of them clipped below at 0, as the reference does (a point seen
    only with negative features gets 0).
    """
    V, H, W, C = feats2d.shape
    proj = [project_points(points, world2cams[i], intr, (H, W),
                           None if depths is None else depths[i]) for i in range(V)]
    pix = torch.stack([p for p, _ in proj])
    valid = torch.stack([m for _, m in proj])
    feats = _gather_views(feats2d, pix, valid)
    w = valid.to(feats.dtype)[..., None]
    if reduce == "mean":
        return (feats * w).sum(0) / w.sum(0).clamp(min=1.0)
    best = torch.amax(torch.where(w > 0, feats, torch.full_like(feats, float("-inf"))), 0)
    return torch.maximum(best, torch.zeros_like(best))
