"""Saliency-map point-dropping attack (ICCV'19), untargeted (port of
`if_defense_tpu/attack/drop.py`; `Saliency/Drop.py:12-109`).

Each round scores every point by -r^alpha <p - median, dL/dp> and drops
the k highest until `num_drop` points are gone. `saliency_drop_masked`
keeps the cloud's shape and masks dropped points out, through the
victims' mask-aware forwards (on the card their FPS and ball query are
kernels B5 and B6 in their masked forms); `saliency_drop_shrink` shrinks
the cloud each round, as the reference does. Both keep the same points.
Top-k ties go to the lower index, as `lax.top_k`'s do: stable sorts.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.nn import functional as F

from if_defense_tpu_torch.ops import index_points


def _median(vals: torch.Tensor, cnt: int) -> torch.Tensor:
    """Per-coordinate median of the first `cnt` rows of the sorted [B, K,
    3] `vals`, the mean of the two middle values where `cnt` is even (as
    `jnp.median`), [B, 1, 3]."""
    lo, hi = (cnt - 1) // 2, cnt // 2
    return 0.5 * (vals[:, lo:lo + 1] + vals[:, hi:hi + 1])


def _saliency(pc: torch.Tensor, grad: torch.Tensor, center: torch.Tensor,
              alpha: float) -> torch.Tensor:
    rel = pc - center
    rad = (rel * rel).sum(dim=-1).sqrt()                     # [B, K]
    return -(rad ** alpha) * (rel * grad).sum(dim=-1)


def _true_class_grad(logits_fn, pc, label, *mask):
    p = pc.detach().requires_grad_(True)
    logp = F.log_softmax(logits_fn(p, *mask), dim=-1)
    loss = -logp.gather(-1, label.long()[:, None]).mean()
    return torch.autograd.grad(loss, p)[0]


def saliency_drop_masked(logits_fn: Callable, data: torch.Tensor,
                         label: torch.Tensor, num_drop: int, k: int = 5,
                         alpha: float = 1.0):
    """Drop at a fixed shape.

    Args:
        logits_fn: (pc [B, K, 3], mask [B, K]) -> [B, C], mask-aware.
        data: [B, K, 3]; label: [B] true labels (untargeted).
    Returns:
        (data unchanged, keep mask [B, K] with K - num_drop ones a cloud,
        still correct [B]: the victim still predicts the true label on the
        masked cloud).
    """
    B, K, _ = data.shape
    mask = torch.ones((B, K), dtype=data.dtype, device=data.device)
    for dropped in range(0, num_drop, k):
        step = min(k, num_drop - dropped)              # the last partial
        grad = _true_class_grad(logits_fn, data, label, mask)
        with torch.no_grad():
            vals = data.masked_fill(~(mask > 0)[..., None], torch.inf)
            center = _median(torch.sort(vals, dim=1).values, K - dropped)
            sal = _saliency(data, grad, center, alpha)
            sal = sal.masked_fill(~(mask > 0), -torch.inf)
            idx = torch.sort(sal, dim=1, descending=True,
                             stable=True).indices[:, :step]
            mask = mask.scatter(1, idx, 0.0)
    with torch.no_grad():
        pred = logits_fn(data, mask).argmax(dim=-1)
    return data, mask, pred == label


def compact_kept(pc: torch.Tensor, mask: torch.Tensor,
                 num_drop: int) -> torch.Tensor:
    """The kept points, in their order, as a dense [B, K - num_drop, 3]."""
    order = torch.argsort(-mask, dim=1, stable=True)        # kept first
    return index_points(pc, order[:, :pc.shape[1] - num_drop])


def saliency_drop(logits_fn: Callable, data: torch.Tensor,
                  label: torch.Tensor, num_drop: int, k: int = 5,
                  alpha: float = 1.0):
    """Drop `num_drop` points through the mask-aware victim `logits_fn(pc,
    mask)`. -> (kept points [B, K - num_drop, 3], still correct [B]: the
    attack failed there, the reference's convention)."""
    pc, mask, still_correct = saliency_drop_masked(
        logits_fn, data, label, num_drop, k, alpha)
    return compact_kept(pc, mask, num_drop), still_correct


def saliency_drop_shrink(logits_fn: Callable, data: torch.Tensor,
                         label: torch.Tensor, num_drop: int, k: int = 5,
                         alpha: float = 1.0):
    """Drop by shrinking the cloud each round, the reference's shape
    policy; `logits_fn` takes [B, N, 3] at any N. Keeps the same points as
    `saliency_drop`. -> (kept [B, K - num_drop, 3], still correct)."""
    pc = data
    for dropped in range(0, num_drop, k):
        step = min(k, num_drop - dropped)
        grad = _true_class_grad(logits_fn, pc, label)
        with torch.no_grad():
            K = pc.shape[1]
            center = _median(torch.sort(pc, dim=1).values, K)
            sal = _saliency(pc, grad, center, alpha)
            # the K - step lowest saliencies, lowest first
            keep = torch.sort(sal, dim=1, stable=True).indices[:, :K - step]
            pc = index_points(pc, keep)
    with torch.no_grad():
        pred = logits_fn(pc).argmax(dim=-1)
    return pc, pred == label
