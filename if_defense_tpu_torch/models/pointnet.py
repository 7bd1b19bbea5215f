"""PointNet classifier (port of `if_defense_tpu/models/pointnet.py`).

STN3d input transform, shared MLP 64-128-1024 (the last layer batch-normed
but not activated before the global max-pool), FC head 512-256-classes
with dropout(0.3) applied before the second batch norm, as the JAX
package (and its reference) does. Channel-last [B, N, 3] in, `(logits,
aux)` out, aux holding the transform matrices.
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
    max_pool_points,
)
from if_defense_tpu_torch.parallel.batch_stats import batch_mean


class STN(nn.Module):
    """Spatial/feature transform net predicting a k x k matrix (+identity);
    its last Dense starts at zero, as flax's `kernel_init=zeros`."""

    def __init__(self, k: int = 3, use_bn: bool = True):
        super().__init__()
        self.k = k
        self.PointwiseMLP_0 = PointwiseMLP(k, [64, 128, 1024], use_bn=use_bn)
        self.DenseBN_0 = DenseBN(1024, 512, use_bn=use_bn)
        self.DenseBN_1 = DenseBN(512, 256, use_bn=use_bn)
        self.Dense_0 = nn.Linear(256, k * k)
        nn.init.zeros_(self.Dense_0.weight)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        # x: [B, N, k]; mask: optional [B, N] validity (masked points are
        # left out of the pool)
        h = max_pool_points(self.PointwiseMLP_0(x), mask)       # [B, 1024]
        h = F.relu(self.DenseBN_0(h))
        h = F.relu(self.DenseBN_1(h))
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(-1)
        return (self.Dense_0(h) + eye).reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    """Global feature: STN -> MLP(64) [-> fSTN] -> MLP(128) -> MLP(1024) ->
    max."""

    def __init__(self, feature_transform: bool = False, use_bn: bool = True):
        super().__init__()
        self.STN_0 = STN(3, use_bn)
        self.PointwiseMLP_0 = PointwiseMLP(3, [64], use_bn=use_bn)
        self.STN_1 = STN(64, use_bn) if feature_transform else None
        self.PointwiseMLP_1 = PointwiseMLP(64, [128], use_bn=use_bn)
        self.PointwiseMLP_2 = PointwiseMLP(128, [1024], use_bn=use_bn,
                                           relu_last=False)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None):
        trans = self.STN_0(xyz, mask)                           # [B, 3, 3]
        x = self.PointwiseMLP_0(torch.bmm(xyz, trans))
        trans_feat = None
        if self.STN_1 is not None:
            trans_feat = self.STN_1(x, mask)
            x = torch.bmm(x, trans_feat)
        x = self.PointwiseMLP_2(self.PointwiseMLP_1(x))
        return max_pool_points(x, mask), trans, trans_feat      # [B, 1024]


class PointNetCls(nn.Module):
    """PointNet classifier; returns (logits [B, num_classes], aux)."""

    def __init__(self, num_classes: int = 40, feature_transform: bool = False,
                 use_bn: bool = True):
        super().__init__()
        self.PointNetFeat_0 = PointNetFeat(feature_transform, use_bn)
        self.DenseBN_0 = DenseBN(1024, 512, use_bn=use_bn)
        self.Dense_0 = nn.Linear(512, 256)
        self.BatchNorm_0 = BatchNorm(256) if use_bn else None
        self.Dense_1 = nn.Linear(256, num_classes)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                draw: Draw | None = None):
        feat, trans, trans_feat = self.PointNetFeat_0(xyz, mask)
        x = F.relu(self.DenseBN_0(feat))
        x = dropout(self.Dense_0(x), 0.3, self.training, draw)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        logits = self.Dense_1(F.relu(x))
        aux = {"trans": trans}
        if trans_feat is not None:
            aux["trans_feat"] = trans_feat
        return logits, aux


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """|| T T^t - I ||_F penalty, averaged over the batch (`batch_mean`:
    over the whole batch inside a shard of a split step)."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)
    m = torch.bmm(trans, trans.transpose(1, 2)) - eye
    return batch_mean(torch.linalg.matrix_norm(m))
