"""PointConv (density SSG) classifier (port of
`if_defense_tpu/models/pointconv.py`).

Three density-weighted set-abstraction levels (512 / 128 / group-all
centres, kNN groups of 32 / 64 / all points, bandwidths 0.1 / 0.2 / 0.4), a
Gaussian-KDE density per point rescaled by a small DensityNet, WeightNet
kernel weights on local coordinates, and a weighted aggregation (an einsum,
which XLA computed in the JAX package; `torch.einsum` here). FC head
512-256-classes with dropout 0.4. The centres are FPS (kernel B5 for CUDA
tensors), the groups exact kNN. Every DensityNet layer ends in ReLU, the
reference's effective behaviour (its sigmoid branch is unreachable).
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
    knn_points,
    square_distance,
)


def compute_density(xyz: torch.Tensor, bandwidth: float,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point Gaussian-KDE density over the whole cloud, [B, N]; with a
    [B, N] validity mask, over (and averaged by) the valid points only."""
    sq = square_distance(xyz, xyz)
    g = torch.exp(-sq / (2.0 * bandwidth * bandwidth)) / (2.5 * bandwidth)
    if mask is None:
        return g.mean(dim=-1)
    m = (mask > 0).to(g.dtype)
    cnt = m.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return (g * m[:, None, :]).sum(dim=-1) / cnt


class DensityNet(nn.Module):
    """1 -> 8 -> 8 -> 1 pointwise MLP rescaling the KDE density."""

    def __init__(self, use_bn: bool = True):
        super().__init__()
        self.PointwiseMLP_0 = PointwiseMLP(1, [8, 8, 1], use_bn=use_bn)

    def forward(self, density: torch.Tensor) -> torch.Tensor:
        return self.PointwiseMLP_0(density[..., None])          # [B, N, 1]


class WeightNet(nn.Module):
    """3 -> 8 -> 8 -> out pointwise MLP on local coordinates."""

    def __init__(self, out: int = 16, use_bn: bool = True):
        super().__init__()
        self.PointwiseMLP_0 = PointwiseMLP(3, [8, 8, out], use_bn=use_bn)

    def forward(self, local_xyz: torch.Tensor) -> torch.Tensor:
        return self.PointwiseMLP_0(local_xyz)


class PointConvSetAbstraction(nn.Module):
    """Density-weighted set abstraction with kNN grouping; `in_channel` is
    the width D of the level's input features (0 for none)."""

    def __init__(self, npoint: int | None, nsample: int | None,
                 in_channel: int, mlp, bandwidth: float,
                 group_all: bool = False, use_bn: bool = True):
        super().__init__()
        self.npoint, self.nsample = npoint, nsample
        self.bandwidth, self.group_all = bandwidth, group_all
        self.DensityNet_0 = DensityNet(use_bn)
        self.PointwiseMLP_0 = PointwiseMLP(in_channel + 3, list(mlp),
                                           use_bn=use_bn)
        self.WeightNet_0 = WeightNet(16, use_bn)
        self.DenseBN_0 = DenseBN(16 * mlp[-1], mlp[-1], use_bn=use_bn)

    def forward(self, xyz, points, mask=None):
        B = xyz.shape[0]
        density = compute_density(xyz, self.bandwidth, mask)    # [B, N]
        density_scale = self.DensityNet_0(density)              # [B, N, 1]
        if mask is not None:
            # masked points add nothing to the (sum) aggregation
            density_scale = density_scale * (mask > 0)[..., None]
        if self.group_all:
            new_xyz = xyz.new_zeros((B, 1, 3))
            grouped_norm = xyz[:, None]                         # [B, 1, N, 3]
            feat = grouped_norm
            if points is not None:
                feat = torch.cat([grouped_norm, points[:, None]], -1)
            grouped_density = density_scale[:, None]            # [B, 1, N, 1]
        else:
            new_xyz = gather_neighbors(
                xyz, farthest_point_sample(xyz, self.npoint, mask=mask))
            idx = knn_points(self.nsample, xyz, new_xyz,
                             candidate_mask=mask)               # [B, S, k]
            grouped_norm = gather_neighbors(xyz, idx) - new_xyz[:, :, None]
            feat = grouped_norm
            if points is not None:
                feat = torch.cat([grouped_norm, gather_neighbors(points, idx)],
                                 -1)
            grouped_density = gather_neighbors(density_scale, idx)
        feat = self.PointwiseMLP_0(feat)
        weights = self.WeightNet_0(grouped_norm)
        # density-weighted kernel aggregation: [B, S, C, 16]
        agg = torch.einsum("bskc,bskw->bscw", feat * grouped_density, weights)
        agg = agg.reshape(B, agg.shape[1], -1)                  # [B, S, C*16]
        return new_xyz, F.relu(self.DenseBN_0(agg))


class PointConvDensityClsSsg(nn.Module):
    """Returns (logits [B, num_classes], {}) on [B, N, 3] input."""

    def __init__(self, num_classes: int = 40, use_bn: bool = True):
        super().__init__()
        self.PointConvSetAbstraction_0 = PointConvSetAbstraction(
            512, 32, 0, (64, 64, 128), 0.1, use_bn=use_bn)
        self.PointConvSetAbstraction_1 = PointConvSetAbstraction(
            128, 64, 128, (128, 128, 256), 0.2, use_bn=use_bn)
        self.PointConvSetAbstraction_2 = PointConvSetAbstraction(
            1, None, 256, (256, 512, 1024), 0.4, group_all=True,
            use_bn=use_bn)
        self.DenseBN_0 = DenseBN(1024, 512, use_bn=use_bn)
        self.DenseBN_1 = DenseBN(512, 256, use_bn=use_bn)
        self.Dense_0 = nn.Linear(256, num_classes)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                draw: Draw | None = None):
        # only level 1 sees the mask: its FPS and kNN select valid points
        # alone, so l1_xyz onward is an all-valid cloud
        l1_xyz, l1 = self.PointConvSetAbstraction_0(xyz, None, mask)
        l2_xyz, l2 = self.PointConvSetAbstraction_1(l1_xyz, l1)
        _, l3 = self.PointConvSetAbstraction_2(l2_xyz, l2)
        x = l3.reshape(l3.shape[0], -1)                          # [B, 1024]
        x = dropout(F.relu(self.DenseBN_0(x)), 0.4, self.training, draw)
        x = dropout(F.relu(self.DenseBN_1(x)), 0.4, self.training, draw)
        return self.Dense_0(x), {}
