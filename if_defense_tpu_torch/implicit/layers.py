"""Shared implicit-network layers (port of `if_defense_tpu/implicit/
layers.py`): the FC ResNet block, flax's batch norm, conditional batch
norm and the two batch-normed ResNet blocks of ONet.

Activations are channel-last `[B, T, F]`, as in the JAX package.
Submodule names follow the flax modules' (`fc_0`, `fc_1`, `shortcut`,
`bn_0`/`bn_1`, `bn`, `conv_gamma`, `conv_beta`), so
`utils.params_io.params_from_jax` maps keys one to one. Training mode is
the module's (`model.train()` / `model.eval()`), where flax passes `train`.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.parallel.batch_stats import current_exchange

BN_MOMENTUM, BN_EPS = 0.9, 1e-5          # every batch norm of the JAX package


class ResnetBlockFC(nn.Module):
    """FC ResNet block: x + fc_1(relu(fc_0(relu(x)))), with a bias-free
    linear shortcut when the width changes. Submodule names follow the flax
    module's, so `utils.params_io.params_from_jax` maps keys one to one."""

    def __init__(self, size_in: int, size_out: int | None = None,
                 size_h: int | None = None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = (nn.Linear(size_in, size_out, bias=False)
                         if size_in != size_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x))))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class BatchNorm(nn.Module):
    """`flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)` over every axis but
    the last.

    In training mode it normalises with the batch's mean and biased
    variance (flax's E[x^2] - E[x]^2, clipped at 0), mean = sum x / n and
    E[x^2] = sum x^2 / n, and moves the running buffers `mean` and `var`
    to 0.9 old + 0.1 batch; `torch.nn.BatchNorm1d` would keep the unbiased
    variance, n/(n-1) larger. Inside a shard of a split step
    (`parallel.batch_stats.StatsExchange.shard`) the sums and n are the
    whole split batch's, so every shard normalises, and moves its
    buffers, as the unsplit batch would. In eval mode it uses the
    buffers. `affine` adds flax's `scale` and `bias`.
    """

    def __init__(self, features: int, affine: bool = True):
        super().__init__()
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.scale = nn.Parameter(torch.ones(features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(features)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            sums = torch.stack([x.sum(axes), (x * x).sum(axes)])
            n = x.numel() // x.shape[-1]
            context = current_exchange()
            if context is not None:
                sums, n = context[0].all_sum(sums, n)
            mean, mean_sq = sums / n
            var = (mean_sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x - mean) * mul
        return y if self.bias is None else y + self.bias


class CBatchNorm(nn.Module):
    """Conditional batch norm: batch norm without affine parameters, then
    gamma(c) * x + beta(c), gamma and beta linear in the latent code
    (flax initialises them to 1 and 0)."""

    def __init__(self, c_dim: int, f_dim: int):
        super().__init__()
        self.conv_gamma = nn.Linear(c_dim, f_dim)
        self.conv_beta = nn.Linear(c_dim, f_dim)
        self.bn = BatchNorm(f_dim, affine=False)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        # x: [B, T, f_dim]; c: [B, c_dim]
        gamma = self.conv_gamma(c)[:, None, :]
        beta = self.conv_beta(c)[:, None, :]
        return gamma * self.bn(x) + beta


class ResnetBlockConv1d(nn.Module):
    """Batch-normed ResNet block: x + fc_1(relu(bn_1(fc_0(relu(bn_0(x))))))."""

    def __init__(self, size_in: int, size_h: int | None = None,
                 size_out: int | None = None):
        super().__init__()
        size_h = size_h or size_in
        size_out = size_out or size_in
        self.bn_0 = BatchNorm(size_in)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.bn_1 = BatchNorm(size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = (nn.Linear(size_in, size_out, bias=False)
                         if size_in != size_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.fc_0(F.relu(self.bn_0(x)))
        dx = self.fc_1(F.relu(self.bn_1(net)))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class CResnetBlockConv1d(nn.Module):
    """Conditional ResNet block:
    x + fc_1(relu(bn_1(fc_0(relu(bn_0(x, c))), c)))."""

    def __init__(self, c_dim: int, size_in: int, size_h: int | None = None,
                 size_out: int | None = None):
        super().__init__()
        size_h = size_h or size_in
        size_out = size_out or size_in
        self.bn_0 = CBatchNorm(c_dim, size_in)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.bn_1 = CBatchNorm(c_dim, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = (nn.Linear(size_in, size_out, bias=False)
                         if size_in != size_out else None)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        net = self.fc_0(F.relu(self.bn_0(x, c)))
        dx = self.fc_1(F.relu(self.bn_1(net, c)))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx
