"""Statistical Outlier Removal (port of `if_defense_tpu/defense/sor.py`).

Per-point mean squared distance to its k=2 nearest neighbours (self
excluded); points with value > mean + alpha * std are outliers (std with
Bessel's n-1, like torch.std). `sor_defense` returns a fixed-shape
(pc, mask) pair; `sor_defense_fixed` reorders the inliers first and pads by
cyclic duplication, which matches ragged evaluation after the standard
`pc[:num_points]` crop.
"""

from __future__ import annotations

import torch

from if_defense_tpu_torch.ops import index_points, knn_self


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


def compact_by_mask(pc: torch.Tensor, mask: torch.Tensor):
    """Reorder inliers first (stable) and pad by cyclic duplication.

    Returns:
        (out [B, K, 3], count [B] int32 inliers per cloud)
    """
    K = pc.shape[1]
    arange = torch.arange(K, device=pc.device)
    # outliers pushed to the end, inlier order kept
    order = torch.argsort((1.0 - mask) * K + arange, dim=-1, stable=True)
    count = mask.sum(dim=-1).to(torch.int32)
    idx = arange[None, :] % count.clamp(min=1)[:, None]
    return index_points(index_points(pc, order), idx), count


def sor_defense_fixed(pc: torch.Tensor, k: int = 2, alpha: float = 1.1):
    """SOR returning fixed-shape inlier-first clouds.

    Returns:
        (out [B, K, 3], count [B] int32): the first count[b] rows are the
        inliers in their original order; the rest cyclically repeat them.
    """
    pc, mask = sor_defense(pc, k, alpha)
    return compact_by_mask(pc, mask)
