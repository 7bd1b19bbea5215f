"""Batched scatter-reduce onto flat cell grids (port of
`scatter_mean_2d` / `pooled_max_by_cell` in `if_defense_tpu/ops/scatter.py`).

The JAX package writes these scatter-free for the TPU (one-hot matmul,
pairwise same-cell mask); on the GPU PyTorch's scatter ops are the direct
form. Neither was a Pallas kernel.
"""

from __future__ import annotations

import torch


def scatter_mean_2d(feat: torch.Tensor, index: torch.Tensor,
                    num_cells: int) -> torch.Tensor:
    """Per-batch mean-scatter of point features into grid cells.

    Args:
        feat: [B, N, C]; index: [B, N] int cell index in [0, num_cells).
    Returns:
        [B, num_cells, C]; empty cells are zero.
    """
    B, N, C = feat.shape
    idx = index.long()
    sums = feat.new_zeros(B, num_cells, C).scatter_add_(
        1, idx[..., None].expand(-1, -1, C), feat)
    counts = feat.new_zeros(B, num_cells).scatter_add_(
        1, idx, feat.new_ones(B, N))
    return sums / counts.clamp_min(1.0)[..., None]


def pooled_max_by_cell(feat: torch.Tensor, index: torch.Tensor,
                       num_cells: int) -> torch.Tensor:
    """Per-POINT max over all points sharing the same cell (scatter_max and
    gather back, the ConvONet encoder's pool_local).

    Args:
        feat: [B, N, C]; index: [B, N] in [0, num_cells).
    Returns:
        [B, N, C]
    """
    B, N, C = feat.shape
    idx = index.long()[..., None].expand(-1, -1, C)
    cell_max = feat.new_full((B, num_cells, C), -torch.inf).scatter_reduce(
        1, idx, feat, reduce="amax", include_self=True)
    return torch.gather(cell_max, 1, idx)
