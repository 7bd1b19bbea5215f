"""Convolutional Occupancy Network (port of the plane-type ConvONet in
`if_defense_tpu/implicit/convonet.py`).

LocalPoolPointnet encoder (hidden 32, c_dim 32, 3 planes xz/xy/yz at 64x64,
scatter-max local pooling, scatter-mean plane projection, one 2D UNet of
depth 4 shared by the planes) and the bilinear-plane LocalDecoder (hidden
32, 5 ResNet blocks). The latent `c` is a dict of three `[B, R, R, c_dim]`
channel-last planes. Plane types only: the `grid` volume is not ported
yet. The mesh path's lattice methods (`lattice_planes`, `decode_lattice`,
`dense_lattice_logits`) resize the planes to the fine lattice once and then
evaluate the decoder head without per-query plane sampling.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import ResnetBlockFC
from if_defense_tpu_torch.implicit.unet2d import UNet2D
from if_defense_tpu_torch.ops import (
    normalize_coordinate,
    plane_features,
    pooled_max_by_cell,
    scatter_mean_2d,
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


class LocalPoolPointnet(nn.Module):
    """3-plane point encoder (`ConvONet/src/encoder/pointnet.py:11-168`)."""

    def __init__(self, c_dim: int = 32, hidden_dim: int = 32,
                 plane_resolution: int = 64, padding: float = 0.1,
                 n_blocks: int = 5, unet_depth: int = 4):
        super().__init__()
        self.reso = plane_resolution
        self.padding = padding
        self.n_blocks = n_blocks
        self.fc_pos = nn.Linear(3, 2 * hidden_dim)
        for i in range(n_blocks):
            self.add_module(f"blocks_{i}",
                            ResnetBlockFC(2 * hidden_dim, hidden_dim))
        self.fc_c = nn.Linear(hidden_dim, c_dim)
        # one UNet shared by the three planes
        self.unet = UNet2D(c_dim, unet_depth, c_dim)

    def forward(self, p: torch.Tensor) -> dict[str, torch.Tensor]:
        # p: [B, T, 3] in the padded unit cube
        R = self.reso
        index = {pl: coordinate2index(normalize_coordinate(p, pl, self.padding), R)
                 for pl in PLANES}
        net = self.blocks_0(self.fc_pos(p))
        for i in range(1, self.n_blocks):
            pooled = 0
            for pl in PLANES:
                pooled = pooled + pooled_max_by_cell(net, index[pl], R * R)
            net = getattr(self, f"blocks_{i}")(torch.cat([net, pooled], -1))
        c = self.fc_c(net)                                   # [B, T, c_dim]
        fea = {}
        for pl in PLANES:
            plane = scatter_mean_2d(c, index[pl], R * R)
            fea[pl] = self.unet(plane.reshape(-1, R, R, c.shape[-1]))
        return fea


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

    def sample_features(self, p: torch.Tensor,
                        c_planes: dict[str, torch.Tensor]) -> torch.Tensor:
        # p: [B, T, 3]; c_planes: {plane: [B, R, R, c_dim]} -> [B, T, c_dim];
        # kernel B4 (one launch for every plane) for CUDA tensors
        if p.is_cuda:
            from if_defense_tpu_torch.ops.cuda_interp import plane_features_cuda

            return plane_features_cuda(p, c_planes, self.padding)
        return plane_features(p, c_planes, self.padding)

    def head(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        # p: [B, T, 3]; c: [B, T, c_dim] sampled features -> logits [B, T]
        net = self.fc_p(p)
        for i in range(self.n_blocks):
            net = net + getattr(self, f"fc_c_{i}")(c)
            net = getattr(self, f"blocks_{i}")(net)
        return self.fc_out(F.relu(net))[..., 0]

    def forward(self, p, c_planes):
        return self.head(p, self.sample_features(p, c_planes))


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
                 plane_resolution: int = 64, padding: float = 0.1):
        super().__init__()
        self.padding = padding
        self.encoder = LocalPoolPointnet(c_dim, hidden_dim, plane_resolution,
                                         padding)
        self.decoder = LocalDecoder(c_dim, hidden_dim, padding=padding)

    def encode_inputs(self, pc: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.encoder(pc)

    def decode(self, p: torch.Tensor, c: dict[str, torch.Tensor]) -> torch.Tensor:
        return self.decoder(p, c)

    def decode_head(self, p: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """Decoder head on presampled features (corner-cache fast path)."""
        return self.decoder.head(p, feat)

    def lattice_planes(self, c: dict[str, torch.Tensor], rf: int,
                       box_size: float) -> dict[str, torch.Tensor]:
        """Each feature plane resized to the (rf+1)^2 fine lattice,
        `[B, rf+1 (H), rf+1 (W), C]`: two small einsums a plane, in the
        planes' type. Sampling a lattice point afterwards is a row gather
        (`decode_lattice`)."""
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
