"""Shared building blocks of the victim classifiers (port of
`if_defense_tpu/models/common.py`).

Activations are channel-last `[B, N, C]` (or `[B, S, K, C]` for groups),
as in the JAX package, so a pointwise "Conv1d(k=1)" is an `nn.Linear` on
the last axis. Batch norms are the port's flax-semantics `BatchNorm` (eps
1e-5, momentum 0.9). Submodules are named as flax auto-names them
(`Dense_0`, `BatchNorm_0`, ... counted per type), so
`utils.params_io.params_from_jax` maps a flax variable tree onto them one
to one. Training mode is the module's (`model.train()` / `model.eval()`),
where flax passes `train`.

Dropout takes its keep masks from a `draw` callable `(shape, rate) -> keep
mask`, which each victim's forward accepts and calls once per dropout
layer in call order (flax draws a mask per `nn.Dropout` from a key folded
per module); `generator_draw` makes one from a `torch.Generator`, and
`split_draw` shares one among the shards of a split batch.
"""

from __future__ import annotations

import threading
from collections.abc import Callable, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import BatchNorm


Draw = Callable[[tuple, float], torch.Tensor]


def generator_draw(gen: torch.Generator) -> Draw:
    """A `draw` whose keep masks come from `gen`, on `gen`'s device: each
    entry kept with probability 1 - rate."""

    def draw(shape: tuple, rate: float) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=gen.device) >= rate

    return draw


def split_draw(draw: Draw, sizes: Sequence[int]) -> list[Draw]:
    """One `draw` per shard of a batch split into shards of `sizes` rows,
    in order. The k-th call of any shard gets its rows of one whole-batch
    mask, drawn from `draw` once, by whichever shard makes its k-th call
    first: the masks are drawn in the unsplit forward's order and are its
    bits, whatever the threads' timing."""
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    total, masks, lock = sum(sizes), [], threading.Lock()

    def shard(i: int) -> Draw:
        calls = 0

        def draw_rows(shape: tuple, rate: float) -> torch.Tensor:
            nonlocal calls
            if shape[0] != sizes[i]:
                raise ValueError(f"shard {i} of {sizes[i]} rows draws "
                                 f"{tuple(shape)}")
            with lock:
                if calls == len(masks):
                    masks.append(draw((total, *shape[1:]), rate))
                mask = masks[calls]
            calls += 1
            if tuple(mask.shape[1:]) != tuple(shape[1:]):
                raise ValueError(f"shard {i}'s dropout call {calls - 1} "
                                 f"draws {tuple(shape)}, another shard's "
                                 f"{tuple(mask.shape)}")
            return mask[starts[i]:starts[i] + sizes[i]]

        return draw_rows

    return [shard(i) for i in range(len(sizes))]


def dropout(x: torch.Tensor, rate: float, training: bool,
            draw: Draw | None = None) -> torch.Tensor:
    """flax's `nn.Dropout(rate)`: in training, `x * keep / (1 - rate)` with
    the keep mask from `draw` (moved to x's device), or from torch's global
    generator (`F.dropout`) where no draw is given; x itself in eval mode,
    where `draw` is never called."""
    if not training:
        return x
    if draw is None:
        return F.dropout(x, rate, True)
    keep = draw(tuple(x.shape), rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def activation(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    """relu, or leaky relu where `negative_slope` > 0."""
    if negative_slope > 0:
        return F.leaky_relu(x, negative_slope)
    return F.relu(x)


class PointwiseMLP(nn.Module):
    """Stack of per-point Dense(+BN)(+activation) layers.

    `relu_last=False` leaves the final layer linear-after-BN (PointNet's
    conv3 before the max-pool).
    """

    def __init__(self, in_features: int, features: Sequence[int],
                 use_bn: bool = True, relu_last: bool = True,
                 negative_slope: float = 0.0, use_bias: bool = True):
        super().__init__()
        self.n = len(features)
        self.use_bn = use_bn
        self.relu_last = relu_last
        self.negative_slope = negative_slope
        cin = in_features
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", nn.Linear(cin, f, bias=use_bias))
            if use_bn:
                self.add_module(f"BatchNorm_{i}", BatchNorm(f))
            cin = f
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            if self.relu_last or i < self.n - 1:
                x = activation(x, self.negative_slope)
        return x


class DenseBN(nn.Module):
    """Dense + optional BatchNorm (no activation)."""

    def __init__(self, in_features: int, features: int, use_bn: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=use_bias)
        self.BatchNorm_0 = BatchNorm(features) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        return x if self.BatchNorm_0 is None else self.BatchNorm_0(x)


def batch_norm_fed_biases(model: nn.Module) -> set[str]:
    """Names of the Dense biases that feed a batch norm directly (in a
    `PointwiseMLP` or `DenseBN` with batch norms). In training the norm
    subtracts the batch mean, so their gradient is 0 in exact arithmetic
    and rounding noise in practice, noise that differs from one device or
    summation order to another."""
    names = set()
    for prefix, m in model.named_modules():
        if isinstance(m, PointwiseMLP) and m.use_bn:
            dense = [f"Dense_{i}" for i in range(m.n)]
        elif isinstance(m, DenseBN) and m.BatchNorm_0 is not None:
            dense = ["Dense_0"]
        else:
            continue
        names |= {f"{prefix}.{d}.bias" for d in dense
                  if getattr(m, d).bias is not None}
    return names


def max_pool_points(x: torch.Tensor, mask: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Global max pool over the point axis: [B, N, C] -> [B, C].

    With a [B, N] validity mask, masked points are excluded: identical (in
    eval mode, where no op mixes points) to pooling the compacted valid
    subset.
    """
    if mask is None:
        return x.amax(dim=1)
    return x.masked_fill(~(mask > 0)[..., None], -torch.inf).amax(dim=1)


def mean_pool_points(x: torch.Tensor, mask: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Global mean pool over the point axis: [B, N, C] -> [B, C], counting
    only valid points when a [B, N] mask is given."""
    if mask is None:
        return x.mean(dim=1)
    m = (mask > 0).to(x.dtype)[..., None]
    cnt = m.sum(dim=1).clamp_min(1.0)
    return (x * m).sum(dim=1) / cnt


def calibrate_batch_norm(model: nn.Module, xyz: torch.Tensor,
                         seed: int = 0) -> nn.Module:
    """Running statistics for a victim without trained weights: every batch
    norm's set to the mean and variance of its input on the clouds `xyz`
    (one train-mode forward from zeroed statistics, which leaves 0.1 x the
    batch's), then perturbed (means by 0.1 std, variances scaled by
    exp(0.2 N(0, 1)), from a CPU generator seeded by `seed`). With fresh
    statistics (mean 0, variance 1) a batch norm's input need not be
    centred, and a ReLU behind it can be dead for every point (PointConv's
    DensityNet ends in one). Returns the model in eval mode."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.mean.zero_()
        m.var.zero_()
    model.train()
    with torch.no_grad():
        model(xyz)
    gen = torch.Generator().manual_seed(seed)
    for m in norms:
        mean, var = m.mean / 0.1, m.var / 0.1
        n = torch.randn((2, *mean.shape), generator=gen).to(mean.device)
        m.mean.copy_(mean + 0.1 * var.sqrt() * n[0])
        m.var.copy_(var * torch.exp(0.2 * n[1]))
    return model.eval()
