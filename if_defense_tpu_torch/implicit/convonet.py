"""Convolutional Occupancy Network (port of
`if_defense_tpu/implicit/convonet.py`).

LocalPoolPointnet encoder (hidden 32, c_dim 32, 3 planes xz/xy/yz at 64x64,
scatter-max local pooling, scatter-mean plane projection, one 2D UNet of
depth 4 shared by the planes) and the bilinear-plane LocalDecoder (hidden
32, 5 ResNet blocks). The latent `c` is a dict of channel-last planes
`[B, R, R, c_dim]` and, with `plane_type` holding "grid", a volume
`[B, Rg, Rg, Rg, c_dim]` (z, y, x; 32^3, smoothed by a 3D UNet of depth 3)
that the decoder samples trilinearly. `PatchLocalPoolPointnet` is the
crop pipelines' encoder, which takes its cell indices from the caller. The
mesh path's lattice methods (`lattice_planes`, `decode_lattice`,
`dense_lattice_logits`) resize the planes to the fine lattice once and then
evaluate the decoder head without per-query plane sampling; they take the
plane types only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import ResnetBlockFC
from if_defense_tpu_torch.implicit.unet2d import UNet2D
from if_defense_tpu_torch.implicit.unet3d import UNet3D
from if_defense_tpu_torch.ops import (
    cell_csr,
    normalize_coordinate,
    plane_features,
    plane_sample,
    pooled_max_by_cell,
    pooled_mean_by_cell,
    scatter_mean_2d,
    trilinear_grid_sample,
)

PLANES = ("xz", "xy", "yz")
# points of the fine lattice that one decoder-head call of
# `dense_lattice_logits` takes (a group of x-slabs): 2^21 points are 256 MB
# per activation at the decoder's 32 channels
LATTICE_GROUP_POINTS = 1 << 21


def coordinate2index(xy: torch.Tensor, reso: int) -> torch.Tensor:
    """Cell index ix + reso * iy (`src/common.py:300-315`), `[B, T]`."""
    x = torch.floor(xy * reso).long()
    return x[..., 0] + reso * x[..., 1]


def normalize_3d_coordinate(p: torch.Tensor, padding: float = 0.1) -> torch.Tensor:
    """Normalise 3D coords to [0, 1) (`src/common.py:260-276`)."""
    return (p / (1 + padding + 1e-3) + 0.5).clamp(0.0, 1.0 - 1e-3)


def coordinate2index_3d(p_nor: torch.Tensor, reso: int) -> torch.Tensor:
    """Cell index ix + reso*(iy + reso*iz) (`src/common.py:300-315`)."""
    x = torch.floor(p_nor * reso).long()
    return x[..., 0] + reso * (x[..., 1] + reso * x[..., 2])


def _cells(pl: str, reso: int, grid_reso: int) -> int:
    return grid_reso**3 if pl == "grid" else reso * reso


class _PooledEncoder(nn.Module):
    """The local-pool ResNet stack and the projection to planes and volume
    that `LocalPoolPointnet` and `PatchLocalPoolPointnet` share; names
    follow the flax modules' (`fc_pos`, `blocks_i`, `fc_c`, `unet`,
    `unet3d`)."""

    def __init__(self, in_dim, c_dim, hidden_dim, plane_resolution,
                 grid_resolution, n_blocks, unet, unet_depth, unet3d_depth,
                 plane_type):
        super().__init__()
        self.reso, self.grid_reso = plane_resolution, grid_resolution
        self.n_blocks = n_blocks
        self.plane_type = tuple(plane_type)
        self.fc_pos = nn.Linear(in_dim, 2 * hidden_dim)
        for i in range(n_blocks):
            self.add_module(f"blocks_{i}",
                            ResnetBlockFC(2 * hidden_dim, hidden_dim))
        self.fc_c = nn.Linear(hidden_dim, c_dim)
        # one 2D UNet shared by the planes, one 3D UNet for the volume
        self.unet = (UNet2D(c_dim, unet_depth, c_dim)
                     if unet and any(pl != "grid" for pl in plane_type)
                     else None)
        self.unet3d = (UNet3D(c_dim, unet3d_depth, c_dim)
                       if unet and "grid" in plane_type else None)

    def project(self, pp, index, pool) -> dict[str, torch.Tensor]:
        # pp: [B, T, in_dim]; index: {plane: [B, T] cell ids}. On the card
        # each plane's pools and scatter-mean share one CSR of its cells.
        cells = {pl: _cells(pl, self.reso, self.grid_reso)
                 for pl in self.plane_type}
        csr = {pl: cell_csr(index[pl], cells[pl]) for pl in self.plane_type}
        net = self.blocks_0(self.fc_pos(pp))
        for i in range(1, self.n_blocks):
            pooled = 0
            for pl in self.plane_type:
                pooled = pooled + pool(net, index[pl], cells[pl],
                                       csr=csr[pl])
            net = getattr(self, f"blocks_{i}")(torch.cat([net, pooled], -1))
        c = self.fc_c(net)                                   # [B, T, c_dim]
        R, Rg, cd = self.reso, self.grid_reso, c.shape[-1]
        fea = {}
        for pl in self.plane_type:
            if pl == "grid":
                vol = scatter_mean_2d(c, index[pl], cells[pl], csr[pl])
                vol = vol.reshape(-1, Rg, Rg, Rg, cd)        # [B, z, y, x, c]
                fea[pl] = vol if self.unet3d is None else self.unet3d(vol)
                continue
            plane = scatter_mean_2d(c, index[pl], cells[pl],
                                    csr[pl]).reshape(-1, R, R, cd)
            fea[pl] = plane if self.unet is None else self.unet(plane)
        return fea


class LocalPoolPointnet(_PooledEncoder):
    """Point encoder to planes and/or a volume
    (`ConvONet/src/encoder/pointnet.py:11-168`); `plane_type` is
    ("xz", "xy", "yz") or ("grid",) or a mix."""

    def __init__(self, c_dim: int = 32, hidden_dim: int = 32,
                 plane_resolution: int = 64, padding: float = 0.1,
                 n_blocks: int = 5, unet: bool = True, unet_depth: int = 4,
                 plane_type=PLANES, grid_resolution: int = 32,
                 unet3d_depth: int = 3):
        super().__init__(3, c_dim, hidden_dim, plane_resolution,
                         grid_resolution, n_blocks, unet, unet_depth,
                         unet3d_depth, plane_type)
        self.padding = padding

    def forward(self, p: torch.Tensor) -> dict[str, torch.Tensor]:
        # p: [B, T, 3] in the padded unit cube
        index = {}
        for pl in self.plane_type:
            if pl == "grid":
                index[pl] = coordinate2index_3d(
                    normalize_3d_coordinate(p, self.padding), self.grid_reso)
            else:
                index[pl] = coordinate2index(
                    normalize_coordinate(p, pl, self.padding), self.reso)
        return self.project(p, index, pooled_max_by_cell)


def positional_encoding_sincos(p: torch.Tensor, n_freqs: int = 10) -> torch.Tensor:
    """NeRF-style sin/cos encoding (`src/common.py:417-439`): [.., D] ->
    [.., 2 * n_freqs * D] with frequencies pi * 2^l, inputs mapped to
    [-1, 1] first."""
    freqs = torch.from_numpy(
        np.pi * 2.0 ** np.linspace(0, n_freqs - 1, n_freqs)).to(
            device=p.device, dtype=p.dtype)
    ang = (2.0 * p - 1.0)[..., None, :] * freqs[:, None]     # [.., L, D]
    out = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)
    return out.reshape(*p.shape[:-1], -1)


def map2local(p: torch.Tensor, unit_size: float,
              pos_encoding: str = "linear") -> torch.Tensor:
    """Coordinates in their local voxel system (`src/common.py:399-415`):
    p mod unit_size, rescaled to [0, 1), optionally sin/cos encoded."""
    q = torch.remainder(p, unit_size) / unit_size
    return positional_encoding_sincos(q) if pos_encoding == "sin_cos" else q


class PatchLocalPoolPointnet(_PooledEncoder):
    """Patch/crop encoder (`ConvONet/src/encoder/pointnet.py:171-329`).

    The local-pool stack of `LocalPoolPointnet`, but the plane/volume cell
    indices come from the caller (crop pipelines index points in the
    local patch frame), `scatter_type` "max" or "mean" picks the local
    pooling, and `local_coord` embeds local-voxel coordinates (`map2local`,
    "linear" or "sin_cos"). `plane_type` names the keys of the index dict
    (flax builds the UNets from the keys at the first call; a torch module
    needs them at construction).
    """

    def __init__(self, c_dim: int = 32, hidden_dim: int = 32,
                 plane_resolution: int = 64, grid_resolution: int = 32,
                 n_blocks: int = 5, unet: bool = True, unet_depth: int = 4,
                 unet3d_depth: int = 3, scatter_type: str = "max",
                 local_coord: bool = False, pos_encoding: str = "linear",
                 unit_size: float = 0.1, plane_type=PLANES):
        in_dim = 60 if local_coord and pos_encoding == "sin_cos" else 3
        super().__init__(in_dim, c_dim, hidden_dim, plane_resolution,
                         grid_resolution, n_blocks, unet, unet_depth,
                         unet3d_depth, plane_type)
        self.pool = (pooled_max_by_cell if scatter_type == "max"
                     else pooled_mean_by_cell)
        self.local_coord, self.pos_encoding = local_coord, pos_encoding
        self.unit_size = unit_size

    def forward(self, p: torch.Tensor,
                index: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        # p: [B, T, 3]; index: {plane: [B, T] cell ids}, keys plane_type's
        if tuple(index) != self.plane_type:
            raise ValueError(f"index planes {tuple(index)} are not the "
                             f"encoder's {self.plane_type}")
        pp = (map2local(p, self.unit_size, self.pos_encoding)
              if self.local_coord else p)
        return self.project(pp, index, self.pool)


class LocalDecoder(nn.Module):
    """Bilinear-plane-conditioned decoder
    (`ConvONet/src/conv_onet/models/decoder.py:8-95`), split into
    `sample_features` (the plane lookups) and `head`."""

    def __init__(self, c_dim: int = 32, hidden_size: int = 32,
                 n_blocks: int = 5, padding: float = 0.1):
        super().__init__()
        self.n_blocks = n_blocks
        self.padding = padding
        self.fc_p = nn.Linear(3, hidden_size)
        for i in range(n_blocks):
            self.add_module(f"fc_c_{i}", nn.Linear(c_dim, hidden_size))
            self.add_module(f"blocks_{i}", ResnetBlockFC(hidden_size))
        self.fc_out = nn.Linear(hidden_size, 1)

    def sample_features(self, p: torch.Tensor, c_planes: dict[str, torch.Tensor],
                        p_n: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
        """p: [B, T, 3]; c_planes: {plane: [B, R, R, c_dim]} and/or a
        'grid' [B, Rg, Rg, Rg, c_dim] volume -> [B, T, c_dim].

        The planes go through kernel B4's p form for CUDA tensors (one
        launch for all of them), the volume through
        `trilinear_grid_sample`, and the planes' sum comes first. `p_n`,
        optional {plane: [B, T, 2|3]} coordinates normalised by the caller
        (the crop pipelines normalise in the patch frame), sends each plane
        to `plane_sample` (B4's uv form) at its own coordinates instead."""
        planes = {pl: c for pl, c in c_planes.items() if pl != "grid"}
        c = 0
        if planes and p_n is not None:
            for pl, plane in planes.items():
                c = c + plane_sample(plane, p_n[pl])
        elif planes and p.is_cuda:
            from if_defense_tpu_torch.ops.cuda_interp import plane_features_cuda

            c = plane_features_cuda(p, planes, self.padding)
        elif planes:
            c = plane_features(p, planes, self.padding)
        if "grid" in c_planes:
            # normalised (x, y, z); the volume is laid out [z, y, x]
            uvw = (p_n["grid"] if p_n is not None
                   else normalize_3d_coordinate(p, self.padding))
            c = c + trilinear_grid_sample(c_planes["grid"], uvw)
        return c

    def head(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        # p: [B, T, 3]; c: [B, T, c_dim] sampled features -> logits [B, T]
        net = self.fc_p(p)
        for i in range(self.n_blocks):
            net = net + getattr(self, f"fc_c_{i}")(c)
            net = getattr(self, f"blocks_{i}")(net)
        return self.fc_out(F.relu(net))[..., 0]

    def forward(self, p, c_planes, p_n=None):
        return self.head(p, self.sample_features(p, c_planes, p_n))


def lattice_axis_selector(rf: int, box_size: float, reso: int,
                          padding: float) -> np.ndarray:
    """[rf+1, reso] f32 selector: fine-lattice axis index -> plane axis.

    Row i holds the bilinear two-hot weights of lattice coordinate i (world
    w = (i/rf - 0.5) * box_size, normalised as `normalize_coordinate`
    does), in float64 before the cast. `S @ plane_axis` therefore equals
    `bilinear_plane_sample` along that axis at every lattice position.
    """
    f = np.arange(rf + 1, dtype=np.float64)
    w = (f / rf - 0.5) * box_size
    u = np.clip(w / (1 + padding + 1e-5) + 0.5, 0.0, 1.0 - 1e-5)
    x = u * (reso - 1)
    x0 = np.floor(x)
    wx = x - x0
    lo = np.clip(x0, 0, reso - 1).astype(np.int64)
    hi = np.clip(x0 + 1, 0, reso - 1).astype(np.int64)
    sel = np.zeros((rf + 1, reso), np.float32)
    np.add.at(sel, (np.arange(rf + 1), lo), 1.0 - wx)
    np.add.at(sel, (np.arange(rf + 1), hi), wx)
    return sel


class ConvOccupancyNetwork(nn.Module):
    """ConvONet with the reference API: encode_inputs / decode /
    decode_head."""

    def __init__(self, c_dim: int = 32, hidden_dim: int = 32,
                 plane_resolution: int = 64, padding: float = 0.1,
                 plane_type=PLANES, grid_resolution: int = 32):
        super().__init__()
        self.padding = padding
        self.plane_type = tuple(plane_type)
        self.encoder = LocalPoolPointnet(
            c_dim, hidden_dim, plane_resolution, padding,
            plane_type=plane_type, grid_resolution=grid_resolution)
        self.decoder = LocalDecoder(c_dim, hidden_dim, padding=padding)

    def encode_inputs(self, pc: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.encoder(pc)

    def decode(self, p: torch.Tensor, c: dict[str, torch.Tensor],
               p_n: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
        return self.decoder(p, c, p_n)

    def decode_head(self, p: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """Decoder head on presampled features (corner-cache fast path)."""
        return self.decoder.head(p, feat)

    def lattice_planes(self, c: dict[str, torch.Tensor], rf: int,
                       box_size: float) -> dict[str, torch.Tensor]:
        """Each feature plane resized to the (rf+1)^2 fine lattice,
        `[B, rf+1 (H), rf+1 (W), C]`: two small einsums a plane, in the
        planes' type. Sampling a lattice point afterwards is a row gather
        (`decode_lattice`). Planes only: a `grid` volume is refused."""
        if "grid" in c:
            raise ValueError("lattice_planes takes plane latents, not a grid")
        first = next(iter(c.values()))
        sel = torch.from_numpy(lattice_axis_selector(
            rf, box_size, self.encoder.reso, self.padding)).to(
                device=first.device, dtype=first.dtype)
        out = {}
        for pl, plane in c.items():
            lat = torch.einsum("ph,bhwc->bpwc", sel, plane)
            out[pl] = torch.einsum("qw,bpwc->bpqc", sel, lat)
        return out

    def decode_lattice(self, fidx: torch.Tensor, lat: dict[str, torch.Tensor],
                       rf: int, box_size: float) -> torch.Tensor:
        """Logits at fine-lattice points from `lattice_planes`' output.

        Args:
            fidx: [B, P, 3] integer lattice coordinates in [0, rf].
        Returns:
            [B, P]: `decode` at the lattice's world coordinates, up to the
            einsums' order of summation.
        """
        rp = rf + 1
        fidx = fidx.long()
        fx, fy, fz = fidx[..., 0], fidx[..., 1], fidx[..., 2]
        # a plane's (H, W) rows follow normalize_coordinate's (v, u):
        # xz -> (z, x), xy -> (y, x), yz -> (z, y)
        rows = {"xz": fz * rp + fx, "xy": fy * rp + fx, "yz": fz * rp + fy}
        feat = 0
        for pl, plane in lat.items():
            B, _, _, C = plane.shape
            flat = plane.reshape(B, rp * rp, C)
            feat = feat + torch.gather(
                flat, 1, rows[pl][..., None].expand(-1, -1, C))
        p = (fidx.float() / rf - 0.5) * box_size
        return self.decoder.head(p.to(feat.dtype), feat)

    def dense_lattice_logits(self, c: dict[str, torch.Tensor], rf: int,
                             box_size: float) -> torch.Tensor:
        """Occupancy logits on the whole (rf+1)^3 lattice.

        With the planes resized to the lattice, the feature at (x, y, z) is
        a broadcast sum of three plane rows, xy[y, x] + xz[z, x] + yz[z, y],
        so the lattice needs no gathers: x-slabs go through the decoder head
        a group at a time (`LATTICE_GROUP_POINTS` points a call). The three
        planes xz, xy, yz only.

        Returns:
            [B, rf+1, rf+1, rf+1] logits in [x][y][z] order.
        """
        if set(c) != set(PLANES):
            raise ValueError(f"dense_lattice_logits takes the planes {PLANES}, "
                             f"not {tuple(c)}")
        lat = self.lattice_planes(c, rf, box_size)
        rp = rf + 1
        xz, xy, yz = lat["xz"], lat["xy"], lat["yz"]      # [B, z|y|z, x|x|y, C]
        B, _, _, C = xz.shape
        dev = xz.device
        axis = (torch.arange(rp, dtype=torch.float32, device=dev) / rf
                - 0.5) * box_size
        yz_t = yz.transpose(1, 2)[:, None]                 # [B, 1, y, z, C]
        py = axis[:, None].expand(rp, rp)
        pz = axis[None, :].expand(rp, rp)
        group = max(1, LATTICE_GROUP_POINTS // (B * rp * rp))
        out = []
        for x0 in range(0, rp, group):
            xs = slice(x0, min(x0 + group, rp))
            g = xs.stop - xs.start
            fxy = xy[:, :, xs].transpose(1, 2)[:, :, :, None]  # [B, g, y, 1, C]
            fxz = xz[:, :, xs].transpose(1, 2)[:, :, None]     # [B, g, 1, z, C]
            f = fxy + fxz + yz_t                               # [B, g, y, z, C]
            p = torch.stack([axis[xs, None, None].expand(g, rp, rp),
                             py.expand(g, rp, rp), pz.expand(g, rp, rp)], -1)
            p = p.to(f.dtype).reshape(1, -1, 3).expand(B, -1, 3)
            logits = self.decoder.head(p, f.reshape(B, -1, C))
            out.append(logits.reshape(B, g, rp, rp))
        return torch.cat(out, 1)

    def forward(self, pc, p):
        return self.decode(p, self.encode_inputs(pc))
