"""Point-cloud normalisation (port of `if_defense_tpu/ops/normalize.py`).

- unit sphere: center at centroid, divide by max radius
  (`ConvONet/opt_defense.py:74-81` `normalize_batch_pc`).
- unit cube: center, divide by the largest axis extent, optional padding
  (`ConvONet/opt_defense.py:114-146` `preprocess_pc`).
"""

from __future__ import annotations

import torch


def normalize_unit_sphere(pc: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Center at the (masked) centroid and scale max radius to 1.

    Args:
        pc: [B, N, 3]
        mask: optional [B, N] validity mask (1 = real point). Masked-out
            points are ignored for the statistics but still transformed.
    Returns:
        [B, N, 3]
    """
    if mask is None:
        centered = pc - pc.mean(dim=1, keepdim=True)
        max_r = centered.square().sum(-1).sqrt().amax(dim=1)
    else:
        cnt = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        centroid = (pc * mask[..., None]).sum(dim=1, keepdim=True) \
            / cnt[..., None]
        centered = pc - centroid
        max_r = (centered.square().sum(-1).sqrt() * mask).amax(dim=1)
    return centered / max_r.clamp_min(1e-12)[:, None, None]


def normalize_unit_cube(pc: torch.Tensor, padding_scale: float = 1.0,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Center at the (masked) mean and scale the largest axis extent to
    `padding_scale` within the unit cube [-0.5, 0.5].

    Args:
        pc: [B, N, 3]
        padding_scale: shrink factor inside the unit cube (the reference
            uses 0.9 for defense preprocessing).
        mask: optional [B, N] validity mask.
    Returns:
        [B, N, 3] scaled points (masked-out points transformed too).
    """
    if mask is None:
        centered = pc - pc.mean(dim=1, keepdim=True)
        extent = centered.amax(dim=1) - centered.amin(dim=1)     # [B, 3]
    else:
        m = mask[..., None]
        cnt = mask.sum(dim=1, keepdim=True).clamp_min(1.0)[..., None]
        centered = pc - (pc * m).sum(dim=1, keepdim=True) / cnt
        valid = m > 0
        big = torch.where(valid, centered, -torch.inf).amax(dim=1)
        small = torch.where(valid, centered, torch.inf).amin(dim=1)
        extent = big - small
    scale = extent.amax(dim=-1)                                  # [B]
    return centered / scale.clamp_min(1e-12)[:, None, None] * padding_scale
