"""VoteNet-style detection head: the port of the reference's
``models/votenet.py``. PointNet++ backbone -> per-seed voting -> vote
aggregation (``PointnetSAModuleVotes``, ``normalize_xyz``) -> proposal decode
with the output keys ``train/detection_losses.py`` and ``eval/detection.py``
read (seed_xyz / seed_inds / vote_xyz / aggregated_vote_xyz /
objectness_scores / center / heading_* / size_* / sem_cls_scores). Module
paths equal the reference's tree paths (``backbone.sa1.mlp.conv0``,
``vgen.out``, ``pnet.vote_aggregation.mlp.bn2``).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from situation3d_tpu_torch.device import resolve_device
from situation3d_tpu_torch.models.layers import Dense
from situation3d_tpu_torch.models.pointnet2_modules import (PointNet2SSG,
                                                            PointnetSAModuleVotes,
                                                            SharedMLP)


class VotingModule(nn.Module):
    """Per-seed vote regression: seed feature -> MLP -> vote_factor x (3 + C);
    votes = seed xyz + offset, vote features = seed features + residual."""

    def __init__(self, vote_factor: int = 1, seed_feature_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = seed_feature_dim
        self.vote_factor, self.seed_feature_dim = vote_factor, C
        self.mlp = SharedMLP(C, (C, C), dtype=dtype)
        self.out = Dense(C, vote_factor * (3 + C), dtype)

    def forward(self, seed_xyz, seed_features, train: bool = False):
        B, num_seed, C = seed_features.shape
        if C != self.seed_feature_dim:
            raise ValueError(f"seed features have {C} channels, not {self.seed_feature_dim}")
        out = self.out(self.mlp(seed_features, train))
        out = out.reshape(B, num_seed, self.vote_factor, 3 + C)
        vote_xyz = seed_xyz[:, :, None, :] + out[..., :3]
        vote_features = seed_features[:, :, None, :] + out[..., 3:]
        return (vote_xyz.reshape(B, num_seed * self.vote_factor, 3),
                vote_features.reshape(B, num_seed * self.vote_factor, C))


class ProposalModule(nn.Module):
    """Vote aggregation + box / class decode: ``PointnetSAModuleVotes`` over
    the votes, then a head of 2 (objectness) + 3 (centre offset) + 2 NH
    (heading) + 4 NS (size) + NC (semantic class) channels per proposal."""

    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 mean_size_arr: np.ndarray, num_proposal: int = 128,
                 sampling_radius: float = 0.3, nsample: int = 16,
                 seed_feature_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_class, self.num_heading_bin = num_class, num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.register_buffer("mean_size_arr", torch.as_tensor(
            np.asarray(mean_size_arr), dtype=torch.float32), persistent=False)
        self.vote_aggregation = PointnetSAModuleVotes(
            npoint=num_proposal, radius=sampling_radius, nsample=nsample,
            mlp=(128, 128, 128), in_channels=seed_feature_dim, normalize_xyz=True,
            dtype=dtype)
        self.proposal_mlp = SharedMLP(128, (128, 128), dtype=dtype)
        self.proposal_out = Dense(
            128, 2 + 3 + num_heading_bin * 2 + num_size_cluster * 4 + num_class, dtype)

    def forward(self, vote_xyz, vote_features, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        nh, ns, nc = self.num_heading_bin, self.num_size_cluster, self.num_class
        agg_xyz, agg_feats, _ = self.vote_aggregation(vote_xyz, vote_features,
                                                      train=train)
        net = self.proposal_out(self.proposal_mlp(agg_feats, train)).float()

        out = {"aggregated_vote_xyz": agg_xyz}
        out["objectness_scores"] = net[..., 0:2]
        out["center"] = agg_xyz + net[..., 2:5]
        o = 5
        out["heading_scores"] = net[..., o:o + nh]
        hrn = net[..., o + nh:o + 2 * nh]
        out["heading_residuals_normalized"] = hrn
        out["heading_residuals"] = hrn * (math.pi / nh)
        o += 2 * nh
        out["size_scores"] = net[..., o:o + ns]
        srn = net[..., o + ns:o + 4 * ns].reshape(*net.shape[:2], ns, 3)
        out["size_residuals_normalized"] = srn
        out["size_residuals"] = srn * self.mean_size_arr[None, None]
        o += 4 * ns
        out["sem_cls_scores"] = net[..., o:o + nc]
        return out


class VoteNet(nn.Module):
    """Backbone + voting + proposals.

    ``forward(xyz [B, N, 3], features=None, valid=None, train=False)`` returns
    the dict the detection loss and the box parser read. Inputs may be numpy
    arrays or tensors; they are moved to the model's device. Parameters are
    float32; ``dtype`` is the compute dtype. ``in_channels`` counts the input
    cloud's feature channels. ``device`` defaults to ``"cuda"`` and raises
    when no card is there. With ``train=True`` the batch norms use and move
    batch statistics.
    """

    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 mean_size_arr: np.ndarray, num_proposal: int = 128,
                 vote_factor: int = 1,
                 backbone_npoints: Sequence[int] = (2048, 1024, 512, 256),
                 dtype: torch.dtype = torch.float32, in_channels: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.backbone = PointNet2SSG(dtype=dtype, npoints=backbone_npoints,
                                     in_channels=in_channels)
        self.vgen = VotingModule(vote_factor, 256, dtype=dtype)
        self.pnet = ProposalModule(num_class, num_heading_bin, num_size_cluster,
                                   mean_size_arr, num_proposal, dtype=dtype)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.vgen.out.weight.device

    def forward(self, xyz, features=None, valid=None, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        xyz, features, valid = (None if t is None else torch.as_tensor(t).to(self.device)
                                for t in (xyz, features, valid))
        end = self.backbone(xyz, features, valid, train)
        seed_xyz, seed_features = end["fp2_xyz"], end["fp2_features"]
        out = {"seed_xyz": seed_xyz, "seed_inds": end["fp2_inds"],
               "seed_features": seed_features}
        vote_xyz, vote_features = self.vgen(seed_xyz, seed_features, train)
        out["vote_xyz"] = vote_xyz
        out.update(self.pnet(vote_xyz, vote_features, train))
        return out
