"""PointNet++ set-abstraction / feature-propagation modules: the port of the
reference's ``models/pointnet2_modules.py``, class for class, over the
channel-last ops of ``ops/pointnet2.py``. Module paths equal the reference's
tree paths (``sa1.mlp.conv0``, ``sa1.mlp.bn0``), so its weights load by
module type (``ckpt_compat/from_jax.py``).

Two things differ from the reference's lazily shaped modules: a constructor
takes the number of input feature channels (``in_channels``; 0 where the
module is called without features), and ``train`` is a call argument of
``forward`` as it is of ``__call__`` there: in training form the batch norms
use and move batch statistics.

Pooling over the ``nsample`` axis uses ``amax``: ball query fills unused
slots with copies of the first hit, so tied maxima are the normal case, and
``amax`` splits the gradient evenly among them, as the reference's ``max``
does (``torch.max(dim)`` would send it to one index).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from situation3d_tpu_torch.models.layers import BatchNorm, Dense
from situation3d_tpu_torch.ops.pointnet2 import (ball_query,
                                                 furthest_point_sample,
                                                 gather_points, group_points,
                                                 interpolation_weights,
                                                 three_interpolate, three_nn)


class SharedMLP(nn.Module):
    """Pointwise MLP with BN + ReLU per layer."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 use_bn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.use_bn = len(channels), use_bn
        for i, c in enumerate(channels):
            self.add_module(f"conv{i}", Dense(in_channels, c, dtype, bias=not use_bn))
            if use_bn:
                self.add_module(f"bn{i}", BatchNorm(c, dtype=dtype))
            in_channels = c

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn{i}")(x, train)
            x = torch.relu(x)
        return x


def _grouped_channels(in_channels: int, use_xyz: bool) -> int:
    """Channels ``QueryAndGroup`` hands the MLP."""
    if in_channels == 0:
        return 3
    return in_channels + 3 if use_xyz else in_channels


class QueryAndGroup(nn.Module):
    """Ball query + grouping with optional xyz concat; ``normalize_xyz``
    divides local coordinates by the radius (the VoteNet variant)."""

    def __init__(self, radius: float, nsample: int, use_xyz: bool = True,
                 normalize_xyz: bool = False):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        self.use_xyz, self.normalize_xyz = use_xyz, normalize_xyz

    def forward(self, xyz, new_xyz, features=None, valid=None):
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz, valid)
        grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.radius
        if features is not None:
            grouped = group_points(features, idx)
            if self.use_xyz:
                grouped = torch.cat([grouped_xyz.to(grouped.dtype), grouped], dim=-1)
        else:
            grouped = grouped_xyz
        return grouped, idx, grouped_xyz


class PointnetSAModule(nn.Module):
    """Single-scale set abstraction."""

    def __init__(self, npoint: int, radius: float, nsample: int, mlp: Sequence[int],
                 in_channels: int = 0, use_xyz: bool = True, pooling: str = "max",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint, self.pooling = npoint, pooling
        self.grouper = QueryAndGroup(radius, nsample, use_xyz)
        self.mlp = SharedMLP(_grouped_channels(in_channels, use_xyz), mlp, dtype=dtype)

    def forward(self, xyz, features=None, valid=None, train: bool = False):
        inds = furthest_point_sample(xyz, self.npoint, valid)
        new_xyz = gather_points(xyz, inds)
        grouped, _, _ = self.grouper(xyz, new_xyz, features, valid)
        h = self.mlp(grouped, train)
        pooled = h.amax(dim=2) if self.pooling == "max" else h.mean(dim=2)
        return new_xyz, pooled, inds


class _MSGBase(nn.Module):
    """Groupers ``grouper{i}`` and MLPs ``mlp{i}``, one per scale."""

    def __init__(self, radii, nsamples, mlps, in_channels, use_xyz, dtype):
        super().__init__()
        self.num_scales = len(radii)
        for i, (r, k, mlp) in enumerate(zip(radii, nsamples, mlps)):
            self.add_module(f"grouper{i}", QueryAndGroup(r, k, use_xyz))
            self.add_module(f"mlp{i}", SharedMLP(
                _grouped_channels(in_channels, use_xyz), mlp, dtype=dtype))

    def _scale(self, i, xyz, new_xyz, features, valid, train):
        grouped, _, _ = getattr(self, f"grouper{i}")(xyz, new_xyz, features, valid)
        return getattr(self, f"mlp{i}")(grouped, train).amax(dim=2)


class PointnetSAModuleMSG(_MSGBase):
    """Multi-scale grouping variant."""

    def __init__(self, npoint: int, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], in_channels: int = 0,
                 use_xyz: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(radii, nsamples, mlps, in_channels, use_xyz, dtype)
        self.npoint = npoint

    def forward(self, xyz, features=None, valid=None, train: bool = False):
        inds = furthest_point_sample(xyz, self.npoint, valid)
        new_xyz = gather_points(xyz, inds)
        outs = [self._scale(i, xyz, new_xyz, features, valid, train)
                for i in range(self.num_scales)]
        return new_xyz, torch.cat(outs, dim=-1), inds


class PointnetSAModuleVotes(nn.Module):
    """Set abstraction with seed-index passthrough and max / avg / rbf
    pooling: the module VoteNet uses to aggregate votes into proposals while
    remembering which seeds produced them."""

    def __init__(self, npoint: int, radius: float, nsample: int, mlp: Sequence[int],
                 in_channels: int = 0, use_xyz: bool = True, pooling: str = "max",
                 sigma: Optional[float] = None, normalize_xyz: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooling not in ("max", "avg", "rbf"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.pooling = pooling
        self.sigma = sigma if sigma is not None else radius / 2
        self.grouper = QueryAndGroup(radius, nsample, use_xyz, normalize_xyz)
        self.mlp = SharedMLP(_grouped_channels(in_channels, use_xyz), mlp, dtype=dtype)

    def forward(self, xyz, features=None, inds=None, valid=None, train: bool = False):
        """Returns (new_xyz [B, np, 3], new_features [B, np, C], inds [B, np])."""
        if inds is None:
            inds = furthest_point_sample(xyz, self.npoint, valid)
        elif inds.shape[1] != self.npoint:
            raise ValueError(f"inds has {inds.shape[1]} columns, npoint is {self.npoint}")
        new_xyz = gather_points(xyz, inds)
        grouped, _, grouped_xyz = self.grouper(xyz, new_xyz, features, valid)
        h = self.mlp(grouped, train)
        if self.pooling == "max":
            pooled = h.amax(dim=2)
        elif self.pooling == "avg":
            pooled = h.mean(dim=2)
        else:
            rbf = torch.exp(-grouped_xyz.square().sum(-1) / (self.sigma ** 2) / 2)
            pooled = (h * rbf[..., None]).sum(dim=2) / float(self.nsample)
        return new_xyz, pooled, inds


class PointnetSAModuleMSGVotes(_MSGBase):
    """MSG set abstraction with seed-index passthrough."""

    def __init__(self, npoint: int, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], in_channels: int = 0,
                 use_xyz: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(radii, nsamples, mlps, in_channels, use_xyz, dtype)
        self.npoint = npoint

    def forward(self, xyz, features=None, inds=None, valid=None, train: bool = False):
        if inds is None:
            inds = furthest_point_sample(xyz, self.npoint, valid)
        new_xyz = gather_points(xyz, inds)
        outs = [self._scale(i, xyz, new_xyz, features, valid, train)
                for i in range(self.num_scales)]
        return new_xyz, torch.cat(outs, dim=-1), inds


class PointnetLFPModuleMSG(_MSGBase):
    """Learnable multi-scale feature propagation from set 1 onto set 2: for
    each scale, group set-1 features around set-2 positions, MLP + max-pool,
    concat set-2 features, post-MLP (one, shared by the scales); scales
    concatenate on channels. ``in_channels`` counts set-1 feature channels,
    ``in_channels2`` set-2's."""

    def __init__(self, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], post_mlp: Sequence[int],
                 in_channels: int = 0, in_channels2: int = 0, use_xyz: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(radii, nsamples, mlps, in_channels, use_xyz, dtype)
        widths = {m[-1] for m in mlps}
        if len(widths) != 1:
            raise ValueError("the shared post-MLP needs scales of one output width")
        self.post_mlp = SharedMLP(widths.pop() + in_channels2, post_mlp, dtype=dtype)

    def forward(self, xyz2, xyz1, features2=None, features1=None, valid1=None,
                train: bool = False):
        """Propagate features from (xyz1, features1) to xyz2 positions.
        Returns [B, N2, len(radii) * post_mlp[-1]]."""
        outs = []
        for i in range(self.num_scales):
            h = self._scale(i, xyz1, xyz2, features1, valid1, train)
            if features2 is not None:
                h = torch.cat([h, features2.to(h.dtype)], dim=-1)
            outs.append(self.post_mlp(h, train))
        return torch.cat(outs, dim=-1)


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN interpolate + unit MLP. ``in_channels`` is
    the width the MLP sees: known features' plus unknown features'."""

    def __init__(self, mlp: Sequence[int], in_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, dtype=dtype)

    def forward(self, unknown, known, unknown_feats, known_feats,
                known_valid=None, train: bool = False):
        if known is not None:
            dist, idx = three_nn(unknown, known, known_valid)
            interp = three_interpolate(known_feats, idx, interpolation_weights(dist))
        else:
            interp = known_feats.expand(*unknown.shape[:2], known_feats.shape[-1])
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats.to(interp.dtype)], dim=-1)
        return self.mlp(interp, train)


class PointNet2SSG(nn.Module):
    """The SSG encoder: SA(2048) -> SA(1024) -> SA(512) -> SA(256) + two FP
    layers (the VoteNet backbone); ``npoints`` shrinks the pyramid for tests,
    ``in_channels`` counts the input cloud's feature channels."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 npoints: Sequence[int] = (2048, 1024, 512, 256), in_channels: int = 0):
        super().__init__()
        n1, n2, n3, n4 = npoints
        self.sa1 = PointnetSAModule(n1, 0.2, 64, (64, 64, 128), in_channels, dtype=dtype)
        self.sa2 = PointnetSAModule(n2, 0.4, 32, (128, 128, 256), 128, dtype=dtype)
        self.sa3 = PointnetSAModule(n3, 0.8, 16, (128, 128, 256), 256, dtype=dtype)
        self.sa4 = PointnetSAModule(n4, 1.2, 16, (128, 128, 256), 256, dtype=dtype)
        self.fp1 = PointnetFPModule((256, 256), 512, dtype=dtype)
        self.fp2 = PointnetFPModule((256, 256), 512, dtype=dtype)

    def forward(self, xyz, features=None, valid=None, train: bool = False):
        xyz1, f1, i1 = self.sa1(xyz, features, valid, train)
        xyz2, f2, i2 = self.sa2(xyz1, f1, None, train)
        xyz3, f3, _ = self.sa3(xyz2, f2, None, train)
        xyz4, f4, _ = self.sa4(xyz3, f3, None, train)
        f3u = self.fp1(xyz3, xyz4, f3, f4, train=train)
        f2u = self.fp2(xyz2, xyz3, f2, f3u, train=train)
        # seed indices into the ORIGINAL cloud: sa2's selection of sa1's selection
        fp2_inds = torch.gather(i1, 1, i2.to(torch.int64))
        return {"fp2_xyz": xyz2, "fp2_features": f2u, "fp2_inds": fp2_inds,
                "sa4_xyz": xyz4, "sa4_features": f4}
