"""3D evaluation metrics (port of `if_defense_tpu/ops/metrics3d.py`)."""

from __future__ import annotations

import torch


def compute_iou(occ1: torch.Tensor, occ2: torch.Tensor) -> torch.Tensor:
    """Volumetric IoU of two occupancy sets at p >= 0.5, [B, ...] -> [B]."""
    o1 = (occ1 >= 0.5).reshape(occ1.shape[0], -1)
    o2 = (occ2 >= 0.5).reshape(occ2.shape[0], -1)
    union = (o1 | o2).sum(dim=-1).to(torch.float32)
    inter = (o1 & o2).sum(dim=-1).to(torch.float32)
    return inter / union.clamp_min(1.0)
