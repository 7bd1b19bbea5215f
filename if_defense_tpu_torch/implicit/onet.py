"""Occupancy Network, ONet (port of `if_defense_tpu/implicit/onet.py`).

The shipped configuration (`ONet/configs/onet_mn40.yaml`): ResnetPointnet
encoder (hidden 512, c_dim 512), conditional-batch-norm decoder
`DecoderCBatchNorm` (hidden 256), z_dim 0. With z_dim > 0 the generative
variant: `LatentEncoder` gives the posterior, `sample_z` draws from it and
`kl_normal` is the ELBO's KL term. `DECODER_REGISTRY` holds the reference's
five decoders.

The modules take the input widths that flax infers (`c_dim`), and their
submodules keep flax's names, so weights carry across by name
(`utils.params_io`). Training mode is the module's (`model.train()`), where
flax passes `train`; the batch norms are flax's (momentum 0.9 on the old
statistic, torch's 0.1 on the new).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import (
    BatchNorm,
    CBatchNorm,
    CResnetBlockConv1d,
    ResnetBlockConv1d,
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


def _act(leaky: bool):
    return (lambda x: F.leaky_relu(x, 0.2)) if leaky else F.relu


class _ZMixin:
    """`fc_z` conditioning on the latent z: z None is the prior mean, zeros,
    as the JAX package has it (the parameters do not depend on the call)."""

    def _z(self, net: torch.Tensor, z: torch.Tensor | None) -> torch.Tensor:
        if z is None:
            return net.new_zeros((net.shape[0], self.z_dim))
        return z


class DecoderCBatchNorm(_ZMixin, nn.Module):
    """CBN decoder (`ONet/im2mesh/onet/models/decoder.py:77-131`):
    `p [B, T, 3]`, `c [B, c_dim]`, optional `z [B, z_dim]` -> logits
    `[B, T]`. `z_dim > 0` adds `fc_z` on the point features."""

    def __init__(self, c_dim: int = 512, hidden_size: int = 256,
                 z_dim: int = 0):
        super().__init__()
        self.z_dim = z_dim
        self.fc_p = nn.Linear(3, hidden_size)
        if z_dim:
            self.fc_z = nn.Linear(z_dim, hidden_size)
        for i in range(5):
            self.add_module(f"block{i}",
                            CResnetBlockConv1d(c_dim, hidden_size))
        self.bn = CBatchNorm(c_dim, hidden_size)
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p: torch.Tensor, c: torch.Tensor,
                z: torch.Tensor | None = None) -> torch.Tensor:
        net = self.fc_p(p)
        if self.z_dim:
            net = net + self.fc_z(self._z(net, z))[:, None]
        for i in range(5):
            net = getattr(self, f"block{i}")(net, c)
        net = self.bn(net, c)
        return self.fc_out(F.relu(net))[..., 0]


class DecoderFC(_ZMixin, nn.Module):
    """Plain decoder (`decoder.py:10-74`): additive z/c conditioning and 5
    FC ResNet blocks. Registry name 'simple'."""

    def __init__(self, hidden_size: int = 128, c_dim: int = 512,
                 z_dim: int = 0):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        self.fc_p = nn.Linear(3, hidden_size)
        if z_dim:
            self.fc_z = nn.Linear(z_dim, hidden_size)
        if c_dim:
            self.fc_c = nn.Linear(c_dim, hidden_size)
        for i in range(5):
            self.add_module(f"block{i}", ResnetBlockFC(hidden_size))
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p, c=None, z=None):
        net = self.fc_p(p)
        if self.z_dim:
            net = net + self.fc_z(self._z(net, z))[:, None]
        if self.c_dim and c is not None:
            net = net + self.fc_c(c)[:, None]
        for i in range(5):
            net = getattr(self, f"block{i}")(net)
        return self.fc_out(F.relu(net))[..., 0]


class LatentEncoder(nn.Module):
    """VAE posterior encoder q(z | points, occ[, c])
    (`ONet/im2mesh/onet/models/encoder_latent.py:12-76`): fc_0 embeds the
    occupancies and fc_pos the coordinates (summed, plus fc_c(c) where
    c_dim > 0); two pool-and-concatenate stages; a last pool -> (mean,
    logstd). `leaky` switches relu / max-pool to leaky-relu(0.2) /
    mean-pool."""

    def __init__(self, z_dim: int = 64, c_dim: int = 0, hidden_dim: int = 128,
                 leaky: bool = False):
        super().__init__()
        h = hidden_dim
        self.c_dim, self.leaky = c_dim, leaky
        self.fc_0 = nn.Linear(1, h)
        self.fc_pos = nn.Linear(3, h)
        if c_dim:
            self.fc_c = nn.Linear(c_dim, h)
        self.fc_1 = nn.Linear(h, h)
        self.fc_2 = nn.Linear(2 * h, h)
        self.fc_3 = nn.Linear(2 * h, h)
        self.fc_mean = nn.Linear(h, z_dim)
        self.fc_logstd = nn.Linear(h, z_dim)

    def _pool(self, x: torch.Tensor, keepdim: bool) -> torch.Tensor:
        # amax: the gradient splits among tied maxima as jnp.max's does
        return (x.mean(1, keepdim=keepdim) if self.leaky
                else x.amax(1, keepdim=keepdim))

    def forward(self, p: torch.Tensor, occ: torch.Tensor,
                c: torch.Tensor | None = None):
        # p: [B, T, 3]; occ: [B, T]; c: optional [B, c_dim]
        act = _act(self.leaky)
        net = self.fc_0(occ[..., None]) + self.fc_pos(p)
        if self.c_dim and c is not None:
            net = net + self.fc_c(c)[:, None]
        net = self.fc_1(act(net))
        net = torch.cat([net, self._pool(net, True).expand_as(net)], -1)
        net = self.fc_2(act(net))
        net = torch.cat([net, self._pool(net, True).expand_as(net)], -1)
        net = self._pool(self.fc_3(act(net)), False)
        return self.fc_mean(net), self.fc_logstd(net)


class DecoderCBatchNorm2(_ZMixin, nn.Module):
    """CBN decoder with a block count (`decoder.py:136-182`); z conditions
    the latent (c = c + fc_z(z)), not the point features."""

    def __init__(self, hidden_size: int = 256, c_dim: int = 128,
                 z_dim: int = 0, n_blocks: int = 5):
        super().__init__()
        self.z_dim, self.n_blocks = z_dim, n_blocks
        self.conv_p = nn.Linear(3, hidden_size)
        if z_dim:
            self.fc_z = nn.Linear(z_dim, c_dim)
        for i in range(n_blocks):
            self.add_module(f"blocks_{i}",
                            CResnetBlockConv1d(c_dim, hidden_size))
        self.bn = CBatchNorm(c_dim, hidden_size)
        self.conv_out = nn.Linear(hidden_size, 1)

    def forward(self, p, c, z=None):
        net = self.conv_p(p)
        if self.z_dim:
            c = c + self.fc_z(self._z(net, z))
        for i in range(self.n_blocks):
            net = getattr(self, f"blocks_{i}")(net, c)
        net = self.bn(net, c)
        return self.conv_out(F.relu(net))[..., 0]


class DecoderCBatchNormNoResnet(_ZMixin, nn.Module):
    """CBN decoder without residual blocks: 5 CBN / activation / fc layers
    and a last CBN (`decoder.py:184-246`)."""

    def __init__(self, c_dim: int = 512, hidden_size: int = 256,
                 z_dim: int = 0, leaky: bool = False):
        super().__init__()
        self.z_dim, self.leaky = z_dim, leaky
        self.fc_p = nn.Linear(3, hidden_size)
        if z_dim:
            self.fc_z = nn.Linear(z_dim, hidden_size)
        for i in range(6):
            self.add_module(f"bn_{i}", CBatchNorm(c_dim, hidden_size))
        for i in range(5):
            self.add_module(f"fc_{i}", nn.Linear(hidden_size, hidden_size))
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p, c, z=None):
        act = _act(self.leaky)
        net = self.fc_p(p)
        if self.z_dim:
            net = net + self.fc_z(self._z(net, z))[:, None]
        for i in range(5):
            net = act(getattr(self, f"bn_{i}")(net, c))
            net = getattr(self, f"fc_{i}")(net)
        net = act(self.bn_5(net, c))
        return self.fc_out(net)[..., 0]


class DecoderBatchNorm(_ZMixin, nn.Module):
    """Plain-BN decoder (`decoder.py:249-310`): additive z/c conditioning,
    5 batch-normed ResNet blocks, a batch norm with scale and bias."""

    def __init__(self, hidden_size: int = 256, c_dim: int = 128,
                 z_dim: int = 0, leaky: bool = False):
        super().__init__()
        self.z_dim, self.c_dim, self.leaky = z_dim, c_dim, leaky
        self.fc_p = nn.Linear(3, hidden_size)
        if z_dim:
            self.fc_z = nn.Linear(z_dim, hidden_size)
        if c_dim:
            self.fc_c = nn.Linear(c_dim, hidden_size)
        for i in range(5):
            self.add_module(f"block{i}", ResnetBlockConv1d(hidden_size))
        self.bn = BatchNorm(hidden_size)
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p, c=None, z=None):
        net = self.fc_p(p)
        if self.z_dim:
            net = net + self.fc_z(self._z(net, z))[:, None]
        if self.c_dim and c is not None:
            net = net + self.fc_c(c)[:, None]
        for i in range(5):
            net = getattr(self, f"block{i}")(net)
        return self.fc_out(_act(self.leaky)(self.bn(net)))[..., 0]


# `ONet/im2mesh/onet/models/__init__.py:12-18`; the legacy voxel/feature
# decoders (implicit/legacy.py) are unregistered in the reference too
DECODER_REGISTRY = {
    "simple": DecoderFC,
    "cbatchnorm": DecoderCBatchNorm,
    "cbatchnorm2": DecoderCBatchNorm2,
    "batchnorm": DecoderBatchNorm,
    "cbatchnorm_noresnet": DecoderCBatchNormNoResnet,
}


class OccupancyNetwork(nn.Module):
    """ONet with the reference API: encode_inputs / decode / infer_z /
    get_z_from_prior; `decode` returns occupancy logits. With z_dim 0 (the
    shipped configuration) the latent is empty; z_dim > 0 adds the
    posterior encoder `encoder_latent` and the decoder's `fc_z`."""

    def __init__(self, c_dim: int = 512, hidden_dim: int = 512,
                 decoder_hidden: int = 256, z_dim: int = 0):
        super().__init__()
        self.z_dim = z_dim
        self.encoder = ResnetPointnet(c_dim, hidden_dim)
        self.decoder = DecoderCBatchNorm(c_dim, decoder_hidden, z_dim)
        if z_dim:
            self.encoder_latent = LatentEncoder(z_dim, c_dim)

    def encode_inputs(self, pc: torch.Tensor) -> torch.Tensor:
        return self.encoder(pc)

    def decode(self, p: torch.Tensor, c: torch.Tensor,
               z: torch.Tensor | None = None) -> torch.Tensor:
        return self.decoder(p, c, z)

    def infer_z(self, p: torch.Tensor, occ: torch.Tensor, c: torch.Tensor):
        """Posterior (mean, logstd) of q(z | p, occ, c), `[B, z_dim]` each
        (empty with z_dim 0)."""
        if not self.z_dim:
            z = p.new_zeros((p.shape[0], 0))
            return z, z.clone()
        return self.encoder_latent(p, occ, c)

    def get_z_from_prior(self, batch: int,
                         generator: torch.Generator | None = None,
                         sample: bool = True) -> torch.Tensor:
        """Prior latent `[batch, z_dim]`: zeros (z_dim 0, `sample=False` or
        no generator) or a N(0, I) draw from `generator`."""
        dev = self.decoder.fc_p.weight.device
        if not self.z_dim or not sample or generator is None:
            return torch.zeros((batch, self.z_dim), device=dev)
        return torch.randn((batch, self.z_dim), generator=generator,
                           device=dev)

    def forward(self, pc: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return self.decode(p, self.encode_inputs(pc))


def sample_z(mean: torch.Tensor, logstd: torch.Tensor,
             generator: torch.Generator | None = None,
             eps: torch.Tensor | None = None) -> torch.Tensor:
    """Reparameterised posterior sample z = mean + exp(logstd) * eps, eps
    given or N(0, I) from `generator`."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(logstd) * eps


def kl_normal(mean: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
    """KL(q(z) || N(0, I)) per example, [B]: the ONet ELBO term."""
    var = torch.exp(2.0 * logstd)
    return 0.5 * (var + mean**2 - 1.0 - 2.0 * logstd).sum(-1)
