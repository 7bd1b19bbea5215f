"""Statistical Outlier Removal (port of `sor_statistics` / `sor_defense` in
`if_defense_tpu/defense/sor.py`).

Per-point mean squared distance to its k=2 nearest neighbours (self
excluded); points with value > mean + alpha * std are outliers (std with
Bessel's n-1, like torch.std). The result is a fixed-shape (pc, mask) pair.
"""

from __future__ import annotations

import torch

from if_defense_tpu_torch.ops import knn_self


def sor_statistics(pc: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Mean squared k-NN distance per point, `[B, K]`."""
    _, dists = knn_self(k, pc, return_dist=True)        # [B, K, k]
    return dists.mean(dim=-1)


def sor_defense(pc: torch.Tensor, k: int = 2, alpha: float = 1.1):
    """Flag statistical outliers.

    Args:
        pc: [B, K, 3]
    Returns:
        (pc, mask): the unchanged points and a `[B, K]` float mask
        (1 = inlier).
    """
    value = sor_statistics(pc, k)
    mean = value.mean(dim=-1, keepdim=True)
    n = value.shape[-1]
    std = (((value - mean) ** 2).sum(dim=-1, keepdim=True) / (n - 1)).sqrt()
    mask = (value <= mean + alpha * std).to(pc.dtype)
    return pc, mask
