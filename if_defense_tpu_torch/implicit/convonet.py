"""Convolutional Occupancy Network (port of the plane-type ConvONet in
`if_defense_tpu/implicit/convonet.py`).

LocalPoolPointnet encoder (hidden 32, c_dim 32, 3 planes xz/xy/yz at 64x64,
scatter-max local pooling, scatter-mean plane projection, one 2D UNet of
depth 4 shared by the planes) and the bilinear-plane LocalDecoder (hidden
32, 5 ResNet blocks). The latent `c` is a dict of three `[B, R, R, c_dim]`
channel-last planes. Plane types only: the `grid` volume is not ported
yet.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import ResnetBlockFC
from if_defense_tpu_torch.implicit.unet2d import UNet2D
from if_defense_tpu_torch.ops import (
    plane_sample,
    pooled_max_by_cell,
    scatter_mean_2d,
)

PLANES = ("xz", "xy", "yz")
_PLANE_AXES = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}


def normalize_coordinate(p: torch.Tensor, plane: str,
                         padding: float = 0.1) -> torch.Tensor:
    """Project to a plane and normalise to [0, 1) (`src/common.py:235-258`)."""
    a, b = _PLANE_AXES[plane]
    xy = torch.stack([p[..., a], p[..., b]], dim=-1)
    xy = xy / (1 + padding + 1e-5) + 0.5
    return xy.clamp(0.0, 1.0 - 1e-5)


def coordinate2index(xy: torch.Tensor, reso: int) -> torch.Tensor:
    """Cell index ix + reso * iy (`src/common.py:300-315`), `[B, T]`."""
    x = torch.floor(xy * reso).long()
    return x[..., 0] + reso * x[..., 1]


class LocalPoolPointnet(nn.Module):
    """3-plane point encoder (`ConvONet/src/encoder/pointnet.py:11-168`)."""

    def __init__(self, c_dim: int = 32, hidden_dim: int = 32,
                 plane_resolution: int = 64, padding: float = 0.1,
                 n_blocks: int = 5, unet_depth: int = 4):
        super().__init__()
        self.reso = plane_resolution
        self.padding = padding
        self.n_blocks = n_blocks
        self.fc_pos = nn.Linear(3, 2 * hidden_dim)
        for i in range(n_blocks):
            self.add_module(f"blocks_{i}",
                            ResnetBlockFC(2 * hidden_dim, hidden_dim))
        self.fc_c = nn.Linear(hidden_dim, c_dim)
        # one UNet shared by the three planes
        self.unet = UNet2D(c_dim, unet_depth, c_dim)

    def forward(self, p: torch.Tensor) -> dict[str, torch.Tensor]:
        # p: [B, T, 3] in the padded unit cube
        R = self.reso
        index = {pl: coordinate2index(normalize_coordinate(p, pl, self.padding), R)
                 for pl in PLANES}
        net = self.blocks_0(self.fc_pos(p))
        for i in range(1, self.n_blocks):
            pooled = 0
            for pl in PLANES:
                pooled = pooled + pooled_max_by_cell(net, index[pl], R * R)
            net = getattr(self, f"blocks_{i}")(torch.cat([net, pooled], -1))
        c = self.fc_c(net)                                   # [B, T, c_dim]
        fea = {}
        for pl in PLANES:
            plane = scatter_mean_2d(c, index[pl], R * R)
            fea[pl] = self.unet(plane.reshape(-1, R, R, c.shape[-1]))
        return fea


class LocalDecoder(nn.Module):
    """Bilinear-plane-conditioned decoder
    (`ConvONet/src/conv_onet/models/decoder.py:8-95`), split into
    `sample_features` (the plane lookups) and `head`."""

    def __init__(self, c_dim: int = 32, hidden_size: int = 32,
                 n_blocks: int = 5, padding: float = 0.1):
        super().__init__()
        self.n_blocks = n_blocks
        self.padding = padding
        self.fc_p = nn.Linear(3, hidden_size)
        for i in range(n_blocks):
            self.add_module(f"fc_c_{i}", nn.Linear(c_dim, hidden_size))
            self.add_module(f"blocks_{i}", ResnetBlockFC(hidden_size))
        self.fc_out = nn.Linear(hidden_size, 1)

    def sample_features(self, p: torch.Tensor,
                        c_planes: dict[str, torch.Tensor]) -> torch.Tensor:
        # p: [B, T, 3]; c_planes: {plane: [B, R, R, c_dim]} -> [B, T, c_dim]
        c = 0
        for pl, plane in c_planes.items():
            c = c + plane_sample(plane, normalize_coordinate(p, pl, self.padding))
        return c

    def head(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        # p: [B, T, 3]; c: [B, T, c_dim] sampled features -> logits [B, T]
        net = self.fc_p(p)
        for i in range(self.n_blocks):
            net = net + getattr(self, f"fc_c_{i}")(c)
            net = getattr(self, f"blocks_{i}")(net)
        return self.fc_out(F.relu(net))[..., 0]

    def forward(self, p, c_planes):
        return self.head(p, self.sample_features(p, c_planes))


class ConvOccupancyNetwork(nn.Module):
    """ConvONet with the reference API: encode_inputs / decode /
    decode_head."""

    def __init__(self, c_dim: int = 32, hidden_dim: int = 32,
                 plane_resolution: int = 64, padding: float = 0.1):
        super().__init__()
        self.padding = padding
        self.encoder = LocalPoolPointnet(c_dim, hidden_dim, plane_resolution,
                                         padding)
        self.decoder = LocalDecoder(c_dim, hidden_dim, padding=padding)

    def encode_inputs(self, pc: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.encoder(pc)

    def decode(self, p: torch.Tensor, c: dict[str, torch.Tensor]) -> torch.Tensor:
        return self.decoder(p, c)

    def decode_head(self, p: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """Decoder head on presampled features (corner-cache fast path)."""
        return self.decoder.head(p, feat)

    def forward(self, pc, p):
        return self.decode(p, self.encode_inputs(pc))
