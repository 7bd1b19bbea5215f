"""Adversarial and distance losses of the attacks (port of
`if_defense_tpu/attack/losses.py`).

Every function returns one value per example, [B], so that callers apply
weights and batch means themselves (the CW framework weights each example).
The attacks take those means with `batch_mean`, which divides by the whole
batch's count inside `shard_of(total)`: a share of a batch split over
devices then gets the gradients the unsplit batch gives it.
Maxima and minima are `amax`/`amin`, which share a gradient among tied
entries as `jnp.max`/`jnp.min` do, and `torch.maximum` halves it at a tie
as `jnp.maximum` does.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.nn import functional as F

from if_defense_tpu_torch.ops import (
    chamfer_distance,
    hausdorff_distance,
    knn_self,
)


# the whole batch's count while this thread runs a share of it
_BATCH_TOTAL = contextvars.ContextVar("batch_total", default=None)


@contextlib.contextmanager
def shard_of(total: int):
    """Inside, `batch_mean` divides by `total`, the count of the batch that
    this thread's examples are a share of."""
    token = _BATCH_TOTAL.set(total)
    try:
        yield
    finally:
        _BATCH_TOTAL.reset(token)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of per-example values [B], `x.sum() /
    total`: inside `shard_of(total)` this share's part of the whole
    batch's mean, else `total` is B. Each example's gradient is the
    incoming one over the count, rounded as `x.mean()`'s is."""
    total = _BATCH_TOTAL.get()
    return x.sum() / (len(x) if total is None else total)


def logits_adv_loss(logits: torch.Tensor, target: torch.Tensor,
                    kappa: float = 0.0) -> torch.Tensor:
    """CW margin loss: max(max_other - target_logit + kappa, 0), [B]."""
    one_hot = F.one_hot(target.long(), logits.shape[1]).to(logits.dtype)
    real = (one_hot * logits).sum(dim=1)
    other = ((1.0 - one_hot) * logits - one_hot * 10000.0).amax(dim=1)
    return torch.maximum(other - real + kappa, torch.zeros_like(real))


def cross_entropy_adv_loss(logits: torch.Tensor,
                           target: torch.Tensor) -> torch.Tensor:
    """Per-example cross entropy toward the target class, [B]."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, target.long()[:, None])[:, 0]


def l2_dist(adv: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
    """Global L2 distance per cloud, [B]; floored at 1e-12 before the sqrt
    so the gradient is finite where adv == ori (the CW init is ori plus
    1e-7 noise, which can round to ori in f32)."""
    sq = ((adv - ori) ** 2).sum(dim=(1, 2))
    return torch.maximum(sq, torch.full_like(sq, 1e-12)).sqrt()


def _direction(a2o: torch.Tensor, o2a: torch.Tensor, method: str):
    if method == "adv2ori":
        return a2o
    if method == "ori2adv":
        return o2a
    return (a2o + o2a) / 2.0


def chamfer_dist(adv: torch.Tensor, ori: torch.Tensor,
                 method: str = "adv2ori") -> torch.Tensor:
    """Chamfer distance in one direction ("adv2ori", "ori2adv") or the mean
    of both, [B]."""
    return _direction(*chamfer_distance(adv, ori), method)


def hausdorff_dist(adv: torch.Tensor, ori: torch.Tensor,
                   method: str = "adv2ori") -> torch.Tensor:
    """Hausdorff distance in one direction or the mean of both, [B]."""
    return _direction(*hausdorff_distance(adv, ori), method)


def knn_dist(pc: torch.Tensor, k: int = 5,
             alpha: float = 1.05) -> torch.Tensor:
    """Outlier-punishing mean kNN distance (AAAI'20), [B].

    The threshold (mean + alpha * std of the per-point mean kNN squared
    distance) is computed on detached values, as the reference's no_grad
    block (and JAX's stop_gradient) does. Selection is exact: JAX's
    `method="approx"` (`approx_max_k`) is a TPU device choice.
    """
    _, d = knn_self(k, pc, return_dist=True)                 # [B, K, k] sq
    value = d.mean(dim=-1)                                   # [B, K]
    stats = value.detach()
    mean = stats.mean(dim=-1, keepdim=True)
    n = stats.shape[-1]
    std = (((stats - mean) ** 2).sum(-1, keepdim=True) / (n - 1)).sqrt()
    mask = (stats > mean + alpha * std).to(pc.dtype)
    return (value * mask).mean(dim=1)


def chamfer_knn_dist(adv: torch.Tensor, ori: torch.Tensor,
                     chamfer_method: str = "adv2ori", knn_k: int = 5,
                     knn_alpha: float = 1.05, chamfer_weight: float = 5.0,
                     knn_weight: float = 3.0) -> torch.Tensor:
    """Geometry-aware distance of the kNN attack (5 CD + 3 kNN), [B]."""
    return (chamfer_weight * chamfer_dist(adv, ori, chamfer_method)
            + knn_weight * knn_dist(adv, knn_k, knn_alpha))


def farthest_dist(clusters: torch.Tensor) -> torch.Tensor:
    """Sum over clusters of the largest pairwise distance within each,
    [B], of added clusters [B, num_add, P, 3]."""
    delta = clusters[:, :, None, :, :] - clusters[:, :, :, None, :] + 1e-7
    norm = (delta * delta).sum(dim=-1).sqrt()                # [B, na, P, P]
    return norm.amax(dim=2).amax(dim=2).sum(dim=1)
