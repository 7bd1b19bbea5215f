"""Clipping and projection of perturbations (port of
`if_defense_tpu/attack/clip.py`), on channel-last [B, K, 3] tensors.

The attacks apply them between optimisation steps, without autograd.
"""

from __future__ import annotations

import torch


def clip_points_l2(pc: torch.Tensor, ori: torch.Tensor,
                   budget: float) -> torch.Tensor:
    """Scale each cloud's whole perturbation into a global L2 ball."""
    diff = pc - ori
    norm = (diff * diff).sum(dim=(1, 2)).sqrt()              # [B]
    scale = torch.clamp_max(budget / (norm + 1e-9), 1.0)
    return ori + diff * scale[:, None, None]


def clip_points_linf(pc: torch.Tensor, ori: torch.Tensor,
                     budget: float) -> torch.Tensor:
    """Scale each point's offset into an L2 ball per point ("l_inf")."""
    diff = pc - ori
    norm = (diff * diff).sum(dim=-1).sqrt()                  # [B, K]
    scale = torch.clamp_max(budget / (norm + 1e-9), 1.0)
    return ori + diff * scale[..., None]


def project_inner_points(pc: torch.Tensor, ori: torch.Tensor,
                         normal: torch.Tensor | None) -> torch.Tensor:
    """Move the offsets of points pushed inside the object (against their
    normal) back onto the surface's tangent plane; a point pushed straight
    in returns to its origin.

    Keeps the reference formula (`clip_utils.py:63-113`) with its
    elementwise `diff * vref / |vref|`, which is no true vector projection.
    """
    if normal is None:
        return pc
    diff = pc - ori
    inner = (diff * normal).sum(dim=-1) < 0.0                # [B, K]
    vng = torch.linalg.cross(normal, diff, dim=-1)           # [B, K, 3]
    vng_norm = (vng * vng).sum(dim=-1).sqrt()
    vref = torch.linalg.cross(vng, normal, dim=-1)
    vref_norm = (vref * vref).sum(dim=-1).sqrt()
    diff_proj = diff * vref / (vref_norm[..., None] + 1e-9)
    opposite = inner & (vng_norm < 1e-6)
    diff_proj = diff_proj.masked_fill(opposite[..., None], 0.0)
    diff = torch.where(inner[..., None], diff_proj, diff)
    return ori + diff


def project_inner_clip_linf(pc: torch.Tensor, ori: torch.Tensor,
                            normal: torch.Tensor | None,
                            budget: float) -> torch.Tensor:
    """Surface projection, then the per-point clip (kNN attack)."""
    return clip_points_linf(project_inner_points(pc, ori, normal), ori,
                            budget)
