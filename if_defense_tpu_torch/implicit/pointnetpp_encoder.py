"""ConvONet with point-feature conditioning (port of
`if_defense_tpu/implicit/pointnetpp_encoder.py`).

Encoder 'pointnet_plus_plus' (`ConvONet/src/encoder/pointnetpp.py`): two
set-abstraction levels (256 centres at r 0.1, then 64 at r 0.2, 16 samples
each, no batch norm) and a feature-propagation level back to the 256
centres. The latent c is (positions [B, 256, 3], features [B, 256, c_dim]).
Decoder 'simple_local_point' (`src/conv_onet/models/decoder.py:201-286`):
each query is conditioned on a Gaussian-weighted average of the features.
FPS and ball query are kernels B5 and B6 for CUDA tensors.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import ResnetBlockFC
from if_defense_tpu_torch.models.pointnet2 import (
    FeaturePropagation,
    SetAbstraction,
)
from if_defense_tpu_torch.ops import square_distance


class PointNetPlusPlusEncoder(nn.Module):
    """Hierarchical SA downsample + FP upsample -> per-point features."""

    def __init__(self, c_dim: int = 32, npoint1: int = 256, npoint2: int = 64):
        super().__init__()
        self.SetAbstraction_0 = SetAbstraction(npoint1, 0.1, 16, 0,
                                               (32, 32, 64), use_bn=False)
        self.SetAbstraction_1 = SetAbstraction(npoint2, 0.2, 16, 64,
                                               (64, 64, 128), use_bn=False)
        self.FeaturePropagation_0 = FeaturePropagation(64 + 128, (c_dim,),
                                                       use_bn=False)

    def forward(self, p: torch.Tensor):
        # p: [B, T, 3] -> (positions [B, npoint1, 3], feats [B, npoint1, c])
        l1_xyz, l1 = self.SetAbstraction_0(p, None)
        l2_xyz, l2 = self.SetAbstraction_1(l1_xyz, l1)
        return l1_xyz, self.FeaturePropagation_0(l1_xyz, l2_xyz, l1, l2)


class LocalPointDecoder(nn.Module):
    """Gaussian point-feature conditioned decoder (`decoder.py:201-286`):
    weights exp(-|p - q|^2 / gaussian_val^2), normalised by their sum (at
    least 1e-12)."""

    def __init__(self, c_dim: int = 32, hidden_size: int = 32,
                 n_blocks: int = 5, gaussian_val: float = 0.1):
        super().__init__()
        self.n_blocks = n_blocks
        self.var = gaussian_val**2
        self.fc_p = nn.Linear(3, hidden_size)
        for i in range(n_blocks):
            self.add_module(f"fc_c_{i}", nn.Linear(c_dim, hidden_size))
            self.add_module(f"blocks_{i}", ResnetBlockFC(hidden_size))
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p: torch.Tensor, c) -> torch.Tensor:
        # p: [B, T, 3]; c = (positions [B, S, 3], feats [B, S, c_dim])
        pos, fea = c
        w = torch.exp(-square_distance(p, pos) / self.var)        # [B, T, S]
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-12)
        cond = torch.bmm(w, fea)                                   # [B, T, c]
        net = self.fc_p(p)
        for i in range(self.n_blocks):
            net = net + getattr(self, f"fc_c_{i}")(cond)
            net = getattr(self, f"blocks_{i}")(net)
        return self.fc_out(F.relu(net))[..., 0]


class PointConvONet(nn.Module):
    """ConvONet variant with point-feature conditioning (encoder
    'pointnet_plus_plus', decoder 'simple_local_point'):
    encode_inputs / decode."""

    def __init__(self, c_dim: int = 32, hidden_dim: int = 32):
        super().__init__()
        self.encoder = PointNetPlusPlusEncoder(c_dim)
        self.decoder = LocalPointDecoder(c_dim, hidden_dim)

    def encode_inputs(self, pc: torch.Tensor):
        return self.encoder(pc)

    def decode(self, p: torch.Tensor, c) -> torch.Tensor:
        return self.decoder(p, c)

    def forward(self, pc: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return self.decode(p, self.encode_inputs(pc))
