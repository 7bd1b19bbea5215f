"""Bilinear feature-plane sampling (port of `if_defense_tpu/ops/interp.py`).

`F.grid_sample(..., padding_mode='border', align_corners=True)` as the
ConvONet decoder uses it, on channel-last planes. `bilinear_plane_sample`
is the plain PyTorch version of kernel B4 (`ops/cuda_interp.py`);
`plane_sample` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors. The corner cache of the fast mode
(`plane_corner_features` / `cached_bilinear_sample`) is plain PyTorch.
"""

from __future__ import annotations

import torch


def _corners(plane: torch.Tensor, uv: torch.Tensor):
    """Floor coordinates, lerp weights and the 4 corner features."""
    B, H, W, C = plane.shape
    x = uv[..., 0].clamp(0.0, 1.0) * (W - 1)                 # [B, Q]
    y = uv[..., 1].clamp(0.0, 1.0) * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x0i = x0.clamp(0, W - 1).long()
    x1i = (x0 + 1).clamp(0, W - 1).long()
    y0i = y0.clamp(0, H - 1).long()
    y1i = (y0 + 1).clamp(0, H - 1).long()
    flat = plane.reshape(B, H * W, C)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi)[..., None].expand(-1, -1, C))

    f = (at(y0i, x0i), at(y0i, x1i), at(y1i, x0i), at(y1i, x1i))
    return x, y, x0, y0, f


def bilinear_plane_sample(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample 2D feature planes at continuous coordinates.

    A coordinate u in [0, 1] maps to pixel position u * (R - 1); out-of-range
    coordinates clamp to the border.

    Args:
        plane: [B, H, W, C] feature planes (channel-last).
        uv: [B, Q, 2] in [0, 1]; uv[..., 0] indexes W (x), uv[..., 1]
            indexes H (y).
    Returns:
        [B, Q, C]
    """
    x, y, x0, y0, (f00, f01, f10, f11) = _corners(plane, uv)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    # the y lerp first, as the JAX package's row-selector einsum does
    col0 = f00 * (1 - wy) + f10 * wy
    col1 = f01 * (1 - wy) + f11 * wy
    return col0 * (1 - wx) + col1 * wx


def plane_sample(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear plane sampling: kernel B4 for CUDA tensors, the plain
    version for CPU tensors."""
    if plane.is_cuda:
        from if_defense_tpu_torch.ops.cuda_interp import plane_sample_cuda

        return plane_sample_cuda(plane, uv)
    return bilinear_plane_sample(plane, uv)


def plane_corner_features(plane: torch.Tensor, uv: torch.Tensor):
    """Gather the 4 bilinear corner features per query (builds the cache).

    Args:
        plane: [B, H, W, C]; uv: [B, Q, 2] in [0, 1] (x, y order).
    Returns:
        (corners [B, Q, 4, C] in (y0x0, y0x1, y1x0, y1x1) order,
         x0f [B, Q] float floor column, y0f [B, Q] float floor row).
    """
    _, _, x0, y0, f = _corners(plane, uv)
    return torch.stack(f, dim=2), x0, y0


def cached_bilinear_sample(corners: torch.Tensor, x0f: torch.Tensor,
                           y0f: torch.Tensor, uv: torch.Tensor,
                           plane_hw) -> torch.Tensor:
    """Re-lerp cached corner features at the current coordinates.

    Equal to `bilinear_plane_sample` while each query stays inside its
    cached cell; past a cell edge the lerp extrapolates linearly.

    Args:
        corners/x0f/y0f: from `plane_corner_features` (no gradient).
        uv: [B, Q, 2] current coordinates; plane_hw: (H, W).
    Returns:
        [B, Q, C]
    """
    H, W = plane_hw
    x = uv[..., 0].clamp(0.0, 1.0) * (W - 1)
    y = uv[..., 1].clamp(0.0, 1.0) * (H - 1)
    wx = (x - x0f)[..., None]
    wy = (y - y0f)[..., None]
    f00, f01, f10, f11 = corners.unbind(dim=2)
    top = f00 * (1 - wx) + f01 * wx
    bot = f10 * (1 - wx) + f11 * wx
    return top * (1 - wy) + bot * wy
