"""Simple Random Sampling defense (port of `if_defense_tpu/defense/srs.py`).

Drops `drop_num` random points per cloud, without replacement. Output shape
is static `[B, K - drop_num, 3]`; the draws come from a `torch.Generator`.
"""

from __future__ import annotations

import torch

from if_defense_tpu_torch.ops import index_points


def srs_defense(pc: torch.Tensor, drop_num: int,
                generator: torch.Generator | None = None,
                perm: torch.Tensor | None = None) -> torch.Tensor:
    """Randomly keep K - drop_num points of each cloud.

    Args:
        pc: [B, K, 3]
        drop_num: number of points to drop.
        generator: source of the draws (on pc's device).
        perm: optional [B, K] permutations to use instead of drawing
            (tests feed JAX's).
    Returns:
        [B, K - drop_num, 3]
    """
    B, K, _ = pc.shape
    keep = K - drop_num
    if keep <= 0:
        raise ValueError(f"drop_num {drop_num} >= cloud size {K}")
    if perm is None:
        perm = torch.argsort(torch.rand((B, K), generator=generator,
                                        device=pc.device), dim=-1)
    return index_points(pc, perm[:, :keep])
