"""DGCNN classifier (port of `if_defense_tpu/models/dgcnn.py`).

A dynamic kNN graph (k = 20, self included) rebuilt on the features before
each of four EdgeConv blocks (64, 64, 128, 256), a 1024-d embedding, max
and mean global pools concatenated, and a leaky-relu(0.2) FC head with
dropout 0.5. The kNN is the port's exact `knn_points` (a stable sort, ties
to the lower index, as `lax.top_k`).
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
    max_pool_points,
    mean_pool_points,
)
from if_defense_tpu_torch.ops import gather_neighbors, knn_points

SLOPE = 0.2


def get_graph_feature(x: torch.Tensor, k: int,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """EdgeConv features [feat_j - feat_i, feat_i] over the kNN graph of
    the features x [B, N, C] -> [B, N, k, 2C]. Masked points ([B, N] mask
    not > 0) are never chosen as neighbours (their own rows are left out of
    the global pools downstream)."""
    idx = knn_points(k, x, candidate_mask=mask)          # [B, N, k], self in
    neigh = gather_neighbors(x, idx)                     # [B, N, k, C]
    center = x[:, :, None, :].expand_as(neigh)
    return torch.cat([neigh - center, center], dim=-1)


class DGCNN(nn.Module):
    """Returns (logits [B, num_classes], {}) on [B, N, 3] input."""

    def __init__(self, num_classes: int = 40, k: int = 20,
                 emb_dims: int = 1024, use_bn: bool = True):
        super().__init__()
        self.k = k
        widths = ((3, 64), (64, 64), (64, 128), (128, 256))
        for i, (cin, cout) in enumerate(widths):
            self.add_module(f"PointwiseMLP_{i}", PointwiseMLP(
                2 * cin, [cout], use_bn=use_bn, negative_slope=SLOPE,
                use_bias=False))
        self.PointwiseMLP_4 = PointwiseMLP(512, [emb_dims], use_bn=use_bn,
                                           negative_slope=SLOPE,
                                           use_bias=False)
        self.DenseBN_0 = DenseBN(2 * emb_dims, 512, use_bn=use_bn,
                                 use_bias=False)
        self.DenseBN_1 = DenseBN(512, 256, use_bn=use_bn)
        self.Dense_0 = nn.Linear(256, num_classes)

    def forward(self, xyz: torch.Tensor, mask: torch.Tensor | None = None,
                draw: Draw | None = None):
        feats, x = [], xyz
        for i in range(4):
            g = get_graph_feature(x, self.k, mask)           # [B, N, k, 2C]
            x = getattr(self, f"PointwiseMLP_{i}")(g).amax(dim=2)
            feats.append(x)
        x = self.PointwiseMLP_4(torch.cat(feats, dim=-1))    # [B, N, 1024]
        x = torch.cat([max_pool_points(x, mask), mean_pool_points(x, mask)],
                      dim=-1)                                # [B, 2048]
        x = F.leaky_relu(self.DenseBN_0(x), SLOPE)
        x = dropout(x, 0.5, self.training, draw)
        x = F.leaky_relu(self.DenseBN_1(x), SLOPE)
        x = dropout(x, 0.5, self.training, draw)
        return self.Dense_0(x), {}
