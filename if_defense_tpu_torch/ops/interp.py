"""Bilinear feature-plane and trilinear volume sampling (port of
`if_defense_tpu/ops/interp.py` and of `normalize_coordinate` in
`if_defense_tpu/implicit/convonet.py`).

`F.grid_sample(..., padding_mode='border', align_corners=True)` as the
ConvONet decoder uses it, on channel-last planes and volumes. Kernel B4 has
two plain versions here: `plane_features` (each plane's
`normalize_coordinate`, `bilinear_plane_sample`, the sum over the planes)
for its p form (`ops/cuda_interp.plane_features_cuda`), and
`bilinear_plane_sample` for its uv form (`plane_sample_cuda`).
`LocalDecoder.sample_features` and `plane_sample` launch the kernel for
CUDA tensors and take the plain version for CPU tensors. The corner cache
of the fast mode (`plane_corner_features` / `cached_bilinear_sample`) and
`trilinear_grid_sample` (XLA, not Pallas, in the JAX package) are plain
PyTorch; the volume's eight corner gathers go through `index_points`, whose
backward on the card is the port's fixed-order kernel.
"""

from __future__ import annotations

import torch

from if_defense_tpu_torch.ops.pointops import index_points

PLANE_AXES = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}


def normalize_coordinate(p: torch.Tensor, plane: str,
                         padding: float = 0.1) -> torch.Tensor:
    """Project to a plane and normalise to [0, 1) (`src/common.py:235-258`)."""
    a, b = PLANE_AXES[plane]
    xy = torch.stack([p[..., a], p[..., b]], dim=-1)
    xy = xy / (1 + padding + 1e-5) + 0.5
    return xy.clamp(0.0, 1.0 - 1e-5)


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
    """`bilinear_plane_sample` (plane `[B, H, W, C]`, uv `[B, Q, 2]`) with
    kernel dispatch: B4's uv form (`cuda_interp.plane_sample_cuda`) for
    CUDA tensors, the plain version for CPU tensors."""
    if uv.is_cuda:
        from if_defense_tpu_torch.ops.cuda_interp import plane_sample_cuda

        return plane_sample_cuda(plane.contiguous(), uv.contiguous())
    return bilinear_plane_sample(plane, uv)


def _axis(coord: torch.Tensor, size: int):
    """Corners lo <= hi (border clamp) and the weight of hi on one axis."""
    i0 = torch.floor(coord)
    return (i0.clamp(0, size - 1).long(), (i0 + 1).clamp(0, size - 1).long(),
            (coord - i0)[..., None])


def trilinear_grid_sample(grid: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """Sample a 3D feature volume at continuous coordinates: grid_sample on
    a 5-D input with align_corners and border padding (the ConvONet `grid`
    latent, `decoder.py:60-67`).

    An explicit 8-corner gather on the flattened volume, lerped along z,
    then y, then x: the order of the JAX package's three contractions.
    `F.grid_sample` is not used: its 5-D backward refuses deterministic
    algorithms and it rounds in its own order. The gradient to uvw is
    elementwise; the volume's, taken only in training, is each corner
    gather's backward (`index_points`: on the card the fixed-order kernel
    of `ops/cuda_gather.py`, not torch's sort-based deterministic form).

    Args:
        grid: [B, D, H, W, C] channel-last feature volume.
        uvw: [B, Q, 3] in [0, 1]; uvw[..., 0] indexes W (x), [..., 1] H (y),
            [..., 2] D (z).
    Returns:
        [B, Q, C]
    """
    B, D, H, W, C = grid.shape
    x0, x1, wx = _axis(uvw[..., 0].clamp(0.0, 1.0) * (W - 1), W)
    y0, y1, wy = _axis(uvw[..., 1].clamp(0.0, 1.0) * (H - 1), H)
    z0, z1, wz = _axis(uvw[..., 2].clamp(0.0, 1.0) * (D - 1), D)
    flat = grid.reshape(B, D * H * W, C)

    def at(zi, yi, xi):
        return index_points(flat, (zi * H + yi) * W + xi)

    def along_z(yi, xi):
        return at(z0, yi, xi) * (1 - wz) + at(z1, yi, xi) * wz

    col0 = along_z(y0, x0) * (1 - wy) + along_z(y1, x0) * wy
    col1 = along_z(y0, x1) * (1 - wy) + along_z(y1, x1) * wy
    return col0 * (1 - wx) + col1 * wx


def plane_features(p: torch.Tensor, planes: dict[str, torch.Tensor],
                   padding: float = 0.1) -> torch.Tensor:
    """Plain version of kernel B4: the sum over the planes, in the dict's
    order, of `bilinear_plane_sample(plane, normalize_coordinate(p, name,
    padding))`.

    Args:
        p: [B, Q, 3] points.
        planes: {name in PLANE_AXES: [B, H, W, C]}.
    Returns:
        [B, Q, C]
    """
    c = 0
    for name, plane in planes.items():
        c = c + bilinear_plane_sample(plane,
                                      normalize_coordinate(p, name, padding))
    return c


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
