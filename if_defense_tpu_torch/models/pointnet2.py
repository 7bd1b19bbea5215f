"""PointNet++ (SSG) classifier (port of `if_defense_tpu/models/pointnet2.py`).

Three set-abstraction levels: sa1 (512 centres, r 0.2, 32 samples, MLP
64-64-128), sa2 (128 centres, r 0.4, 64 samples, MLP 128-128-256), sa3
(group-all, MLP 256-512-1024), then an FC head with dropout 0.4.

FPS and ball query are kernels B5 and B6 for CUDA tensors
(`ops.farthest_point_sample`, `ops.query_ball_point`), their plain versions
for CPU tensors; with a mask, their masked forms.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.models.common import (
    DenseBN,
    Draw,
    PointwiseMLP,
    dropout,
)
from if_defense_tpu_torch.ops import (
    farthest_point_sample,
    gather_neighbors,
    index_points,
    knn_points,
    query_ball_point,
)


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: torch.Tensor | None,
                     mask: torch.Tensor | None = None):
    """FPS centres + ball-query groups with centred coordinates.

    Args:
        xyz: [B, N, 3]; points: [B, N, D] or None.
        mask: optional [B, N] validity: masked points are neither FPS
            centres nor ball-query members, so every group holds only valid
            points and later levels need no mask.
    Returns:
        new_xyz [B, npoint, 3], grouped [B, npoint, nsample, 3(+D)]
    """
    new_xyz = gather_neighbors(xyz, farthest_point_sample(xyz, npoint,
                                                          mask=mask))
    idx = query_ball_point(radius, nsample, xyz, new_xyz, mask=mask)
    grouped = gather_neighbors(xyz, idx) - new_xyz[:, :, None, :]
    if points is not None:
        grouped = torch.cat([grouped, gather_neighbors(points, idx)], -1)
    return new_xyz, grouped


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None):
    """One group of every point, centred at the origin."""
    B, _, C = xyz.shape
    new_xyz = xyz.new_zeros((B, 1, C))
    grouped = xyz[:, None]
    if points is not None:
        grouped = torch.cat([grouped, points[:, None]], -1)
    return new_xyz, grouped


class SetAbstraction(nn.Module):
    """Grouped pointwise MLP + max-pool over each neighbourhood; `in_channel`
    is the width D of the level's input features (0 for none)."""

    def __init__(self, npoint: int | None, radius: float | None,
                 nsample: int | None, in_channel: int, mlp,
                 group_all: bool = False, use_bn: bool = True):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.PointwiseMLP_0 = PointwiseMLP(in_channel + 3, list(mlp),
                                           use_bn=use_bn)

    def forward(self, xyz, points, mask=None):
        if self.group_all:
            new_xyz, grouped = sample_and_group_all(xyz, points)
        else:
            new_xyz, grouped = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points, mask)
        return new_xyz, self.PointwiseMLP_0(grouped).amax(dim=2)


class SetAbstractionMsg(nn.Module):
    """Multi-scale grouping: several (radius, nsample, mlp) branches around
    shared FPS centres, concatenated channel-wise."""

    def __init__(self, npoint: int, radius_list, nsample_list, in_channel: int,
                 mlp_list, use_bn: bool = True):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = radius_list, nsample_list
        for i, mlp in enumerate(mlp_list):
            self.add_module(f"PointwiseMLP_{i}", PointwiseMLP(
                in_channel + 3, list(mlp), use_bn=use_bn))

    def forward(self, xyz, points):
        new_xyz = gather_neighbors(xyz, farthest_point_sample(xyz,
                                                              self.npoint))
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list,
                                                  self.nsample_list)):
            idx = query_ball_point(radius, nsample, xyz, new_xyz)
            grouped = gather_neighbors(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([gather_neighbors(points, idx), grouped],
                                    -1)
            mlp = getattr(self, f"PointwiseMLP_{i}")
            outs.append(mlp(grouped).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """Inverse-distance 3-NN feature upsampling + pointwise MLP; `in_channel`
    is the width of points1 and points2 together."""

    def __init__(self, in_channel: int, mlp, use_bn: bool = True):
        super().__init__()
        self.PointwiseMLP_0 = PointwiseMLP(in_channel, list(mlp),
                                           use_bn=use_bn)

    def forward(self, xyz1, xyz2, points1, points2):
        # xyz1 [B, N, 3] targets; xyz2 [B, S, 3] sources with points2
        B, N, _ = xyz1.shape
        if xyz2.shape[1] == 1:
            interp = points2.expand(B, N, points2.shape[-1])
        else:
            idx, d = knn_points(3, xyz2, xyz1, return_dist=True)
            w = 1.0 / (d + 1e-8)
            w = w / w.sum(-1, keepdim=True)
            interp = (index_points(points2, idx) * w[..., None]).sum(2)
        if points1 is not None:
            interp = torch.cat([points1, interp], dim=-1)
        return self.PointwiseMLP_0(interp)


class PointNet2ClsSsg(nn.Module):
    """Returns (logits [B, num_classes], {}) on [B, N, 3] input."""

    def __init__(self, num_classes: int = 40, use_bn: bool = True):
        super().__init__()
        self.SetAbstraction_0 = SetAbstraction(512, 0.2, 32, 0, (64, 64, 128),
                                               use_bn=use_bn)
        self.SetAbstraction_1 = SetAbstraction(128, 0.4, 64, 128,
                                               (128, 128, 256), use_bn=use_bn)
        self.SetAbstraction_2 = SetAbstraction(None, None, None, 256,
                                               (256, 512, 1024),
                                               group_all=True, use_bn=use_bn)
        self.DenseBN_0 = DenseBN(1024, 512, use_bn=use_bn)
        self.DenseBN_1 = DenseBN(512, 256, use_bn=use_bn)
        self.Dense_0 = nn.Linear(256, num_classes)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                draw: Draw | None = None):
        # only level 1 sees the mask: its FPS and ball query select valid
        # points alone, so l1_xyz onward is an all-valid cloud
        l1_xyz, l1 = self.SetAbstraction_0(xyz, None, mask)
        l2_xyz, l2 = self.SetAbstraction_1(l1_xyz, l1)
        _, l3 = self.SetAbstraction_2(l2_xyz, l2)
        x = l3.reshape(l3.shape[0], -1)                          # [B, 1024]
        x = dropout(F.relu(self.DenseBN_0(x)), 0.4, self.training, draw)
        x = dropout(F.relu(self.DenseBN_1(x)), 0.4, self.training, draw)
        return self.Dense_0(x), {}
