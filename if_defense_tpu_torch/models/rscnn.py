"""RS-CNN classifier (Relation-Shape CNN, single-scale; port of
`if_defense_tpu/models/rscnn.py`).

Hierarchical set abstraction where each neighbourhood's aggregation weights
are learned from low-level relations h_ij = [d_ij, x_j - x_i, x_i, x_j]
(10-d) by a shared MLP, applied to the neighbours' features channel-wise,
max-aggregated and channel-raised. Level 1: 512 centres, r 0.23, 48
samples; level 2: 128 centres, r 0.32, 64 samples; level 3 groups all. FPS
and ball query are kernels B5 and B6 for CUDA tensors.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import BatchNorm
from if_defense_tpu_torch.models.common import (
    DenseBN,
    Draw,
    PointwiseMLP,
    dropout,
)
from if_defense_tpu_torch.ops import (
    farthest_point_sample,
    gather_neighbors,
    query_ball_point,
)


def relation_features(grouped_xyz: torch.Tensor,
                      new_xyz: torch.Tensor) -> torch.Tensor:
    """h_ij = [||x_j - x_i||, x_j - x_i, x_i, x_j], [B, S, ns, 10]."""
    diff = grouped_xyz - new_xyz[:, :, None, :]
    dist = (diff * diff).sum(-1, keepdim=True).clamp_min(1e-12).sqrt()
    center = new_xyz[:, :, None, :].expand_as(grouped_xyz)
    return torch.cat([dist, diff, center, grouped_xyz], dim=-1)


class RelationConv(nn.Module):
    """One RS-Conv layer: learned relation weights -> mul -> max -> raise.
    `in_ch` is the width of the grouped features: the input features', or 3
    (centred coordinates) where the level has none."""

    def __init__(self, npoint: int | None, radius: float | None,
                 nsample: int | None, in_ch: int, out_ch: int,
                 group_all: bool = False, use_bn: bool = True):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        mid = max(in_ch // 2, 16)
        self.PointwiseMLP_0 = PointwiseMLP(10, [mid], use_bn=use_bn)
        self.Dense_0 = nn.Linear(mid, in_ch)
        self.BatchNorm_0 = BatchNorm(in_ch) if use_bn else None
        self.DenseBN_0 = DenseBN(in_ch, out_ch, use_bn=use_bn)

    def forward(self, xyz, feats, mask=None):
        B = xyz.shape[0]
        if self.group_all:
            new_xyz = xyz.new_zeros((B, 1, 3))
            grouped_xyz = xyz[:, None]                          # [B, 1, N, 3]
            grouped_feats = (feats[:, None] if feats is not None
                             else grouped_xyz)
        else:
            new_xyz = gather_neighbors(
                xyz, farthest_point_sample(xyz, self.npoint, mask=mask))
            idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz,
                                   mask=mask)
            grouped_xyz = gather_neighbors(xyz, idx)
            grouped_feats = (gather_neighbors(feats, idx) if feats is not None
                             else grouped_xyz - new_xyz[:, :, None, :])
        h = relation_features(grouped_xyz, new_xyz)             # [B, S, ns, 10]
        w = self.Dense_0(self.PointwiseMLP_0(h))                # no act on last
        agg = (w * grouped_feats).amax(dim=2)                   # [B, S, in_ch]
        if self.BatchNorm_0 is not None:
            agg = self.BatchNorm_0(agg)
        return new_xyz, F.relu(self.DenseBN_0(F.relu(agg)))     # channel raising


class RSCNN(nn.Module):
    """RS-CNN SSN classifier; returns (logits [B, num_classes], {})."""

    def __init__(self, num_classes: int = 40, use_bn: bool = True):
        super().__init__()
        self.RelationConv_0 = RelationConv(512, 0.23, 48, 3, 128,
                                           use_bn=use_bn)
        self.RelationConv_1 = RelationConv(128, 0.32, 64, 128, 512,
                                           use_bn=use_bn)
        self.RelationConv_2 = RelationConv(None, None, None, 512, 1024,
                                           group_all=True, use_bn=use_bn)
        self.DenseBN_0 = DenseBN(1024, 512, use_bn=use_bn)
        self.DenseBN_1 = DenseBN(512, 256, use_bn=use_bn)
        self.Dense_0 = nn.Linear(256, num_classes)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                draw: Draw | None = None):
        # only level 1 sees the mask: its FPS and ball query select valid
        # points alone, so l1_xyz onward is an all-valid cloud
        l1_xyz, l1 = self.RelationConv_0(xyz, None, mask)
        l2_xyz, l2 = self.RelationConv_1(l1_xyz, l1)
        _, l3 = self.RelationConv_2(l2_xyz, l2)
        x = l3.reshape(l3.shape[0], -1)                          # [B, 1024]
        x = dropout(F.relu(self.DenseBN_0(x)), 0.5, self.training, draw)
        x = dropout(F.relu(self.DenseBN_1(x)), 0.5, self.training, draw)
        return self.Dense_0(x), {}
