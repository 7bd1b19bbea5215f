"""Occupancy Network, ONet (port of `if_defense_tpu/implicit/onet.py`).

The shipped configuration (`ONet/configs/onet_mn40.yaml`): ResnetPointnet
encoder (hidden 512, c_dim 512), conditional-batch-norm decoder
`DecoderCBatchNorm` (hidden 256), z_dim 0. The other decoders of the JAX
package's `DECODER_REGISTRY`, `LatentEncoder` and z_dim > 0 are not ported
yet (ROADMAP).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import (
    CBatchNorm,
    CResnetBlockConv1d,
    ResnetBlockFC,
)


class ResnetPointnet(nn.Module):
    """Pooled FC-ResNet point encoder: `[B, T, 3]` -> `[B, c_dim]`.

    Pools with `amax`, whose gradient splits equally among tied maxima as
    `jnp.max`'s does (`torch.max(dim)` would route it to one index)."""

    def __init__(self, c_dim: int = 512, hidden_dim: int = 512):
        super().__init__()
        h = hidden_dim
        self.fc_pos = nn.Linear(3, 2 * h)
        for i in range(5):
            self.add_module(f"block_{i}", ResnetBlockFC(2 * h, h))
        self.fc_c = nn.Linear(h, c_dim)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        net = self.block_0(self.fc_pos(p))
        for i in range(1, 5):
            pooled = net.amax(dim=1, keepdim=True).expand_as(net)
            net = getattr(self, f"block_{i}")(torch.cat([net, pooled], -1))
        return self.fc_c(F.relu(net.amax(dim=1)))


class DecoderCBatchNorm(nn.Module):
    """CBN decoder: `p [B, T, 3]`, `c [B, c_dim]` -> logits `[B, T]`."""

    def __init__(self, c_dim: int = 512, hidden_size: int = 256):
        super().__init__()
        self.fc_p = nn.Linear(3, hidden_size)
        for i in range(5):
            self.add_module(f"block{i}",
                            CResnetBlockConv1d(c_dim, hidden_size))
        self.bn = CBatchNorm(c_dim, hidden_size)
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        net = self.fc_p(p)
        for i in range(5):
            net = getattr(self, f"block{i}")(net, c)
        net = self.bn(net, c)
        return self.fc_out(F.relu(net))[..., 0]


class OccupancyNetwork(nn.Module):
    """ONet with the reference API: encode_inputs / decode / infer_z /
    get_z_from_prior. With z_dim 0 the latent is empty, as in the shipped
    configuration; `decode` returns occupancy logits."""

    def __init__(self, c_dim: int = 512, hidden_dim: int = 512,
                 decoder_hidden: int = 256):
        super().__init__()
        self.encoder = ResnetPointnet(c_dim, hidden_dim)
        self.decoder = DecoderCBatchNorm(c_dim, decoder_hidden)

    def encode_inputs(self, pc: torch.Tensor) -> torch.Tensor:
        return self.encoder(pc)

    def decode(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return self.decoder(p, c)

    def infer_z(self, p: torch.Tensor, occ: torch.Tensor, c: torch.Tensor):
        """Posterior (mean, logstd) of the latent: empty, `[B, 0]` each."""
        z = p.new_zeros((p.shape[0], 0))
        return z, z.clone()

    def get_z_from_prior(self, batch: int) -> torch.Tensor:
        """Prior latent: empty, `[batch, 0]`."""
        return torch.zeros((batch, 0), device=self.decoder.fc_p.weight.device)

    def forward(self, pc: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return self.decode(p, self.encode_inputs(pc))
