"""3D UNet for the ConvONet `grid` feature volume (port of
`if_defense_tpu/implicit/unet3d.py`).

3x3x3 same-padding double convs with ReLU (no group norm, as the JAX
package), 2x2x2 max-pool downs, 2x2x2 stride-2 transpose-conv ups with skip
concatenation, final 1x1x1 conv. NCDHW inside, channel-last
`[B, D, H, W, C]` at the boundary. The stride-2 up-conv with k = s has no
overlap and doubles each axis exactly; its weight is flax's kernel flipped
on the three spatial axes (`utils.params_io`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class DownConv3D(nn.Module):
    def __init__(self, cin: int, features: int, pooling: bool = True):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, features, 3, padding=1)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1)
        self.pooling = pooling

    def forward(self, x):
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        before_pool = x
        if self.pooling:
            x = F.max_pool3d(x, 2, 2)
        return x, before_pool


class UpConv3D(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.upconv = nn.ConvTranspose3d(cin, features, 2, stride=2)
        self.conv1 = nn.Conv3d(2 * features, features, 3, padding=1)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1)

    def forward(self, from_down, from_up):
        x = torch.cat([self.upconv(from_up), from_down], dim=1)
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class UNet3D(nn.Module):
    """[B, D, H, W, start_filts] -> [B, D, H, W, num_classes]; D, H, W
    divisible by 2^(depth-1)."""

    def __init__(self, num_classes: int = 32, depth: int = 3,
                 start_filts: int = 32):
        super().__init__()
        self.depth = depth
        cin = start_filts
        for i in range(depth):
            feats = start_filts * 2**i
            self.add_module(f"down_{i}", DownConv3D(cin, feats, i < depth - 1))
            cin = feats
        for i in range(depth - 1):
            feats = start_filts * 2 ** (depth - 2 - i)
            self.add_module(f"up_{i}", UpConv3D(cin, feats))
            cin = feats
        self.conv_final = nn.Conv3d(cin, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        encoder_outs = []
        for i in range(self.depth):
            x, before = getattr(self, f"down_{i}")(x)
            encoder_outs.append(before)
        for i in range(self.depth - 1):
            x = getattr(self, f"up_{i}")(encoder_outs[-(i + 2)], x)
        return self.conv_final(x).permute(0, 2, 3, 4, 1).contiguous()
