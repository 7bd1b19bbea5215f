"""Legacy ONet decoders (port of `if_defense_tpu/implicit/legacy.py`;
`ONet/im2mesh/onet/models/legacy.py`).

- `VoxelDecoder` (legacy.py:7-70): latent -> 4^3 seed volume -> three
  stride-2 transposed convs -> 32^3 feature volume, sampled trilinearly at
  the query points, then a small FC ResNet head.
- `FeatureDecoder` (legacy.py:73-125): a latent-conditioned affine
  (perspective) projection of the query points into a 2D feature map,
  bilinear sampling (`ops.plane_sample`: kernel B4's uv form on the card),
  then an FC ResNet head.

The JAX package writes the reference's ConvTranspose3d(stride 2, padding 1,
output_padding 1) as flax `nn.ConvTranspose((3, 3, 3), strides 2,
padding="SAME")`. That equals torch's `conv_transpose3d` with padding 0
and the spatially flipped kernel, cropped to the first 2n of its 2n + 1
outputs on each axis; torch's padding 1 / output_padding 1 is the same
operation shifted one voxel. The port follows the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from if_defense_tpu_torch.implicit.layers import ResnetBlockFC
from if_defense_tpu_torch.ops import plane_sample, trilinear_grid_sample


class AffineLayer(nn.Module):
    """Latent-conditioned affine map of points p @ A(c) + b(c)
    (`im2mesh/layers.py:159-191`), initialised to the identity with the
    reference's offset b = (0, 0, 2): zero kernels, biases eye and
    (0, 0, 2)."""

    def __init__(self, c_dim: int, dim: int = 3):
        super().__init__()
        self.dim = dim
        self.fc_A = nn.Linear(c_dim, dim * dim)
        self.fc_b = nn.Linear(c_dim, dim)
        with torch.no_grad():
            self.fc_A.weight.zero_()
            self.fc_A.bias.copy_(torch.eye(dim).reshape(-1))
            self.fc_b.weight.zero_()
            self.fc_b.bias.copy_(torch.tensor([0.0, 0.0, 2.0][:dim]))

    def forward(self, c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        # c: [B, c_dim]; p: [B, T, dim]
        A = self.fc_A(c).reshape(-1, self.dim, self.dim)
        return torch.bmm(p, A) + self.fc_b(c)[:, None, :]


class VoxelDecoder(nn.Module):
    """Volumetric legacy decoder (`legacy.py:7-70`): p [B, T, 3] in
    [-0.5, 0.5], c [B, c_dim], z [B, z_dim] or None (zeros) -> logits
    [B, T]."""

    def __init__(self, z_dim: int = 128, c_dim: int = 128,
                 hidden_size: int = 128):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        self.fc_in = nn.Linear(z_dim + c_dim, 256 * 4 * 4 * 4)
        cin = 256
        for i, ch in enumerate((128, 64, 32)):
            self.add_module(f"convtrp_{i}",
                            nn.ConvTranspose3d(cin, ch, 3, stride=2))
            cin = ch
        self.fc_f = nn.Linear(32, hidden_size)
        self.fc_p = nn.Linear(3, hidden_size)
        if z_dim:
            self.fc_z = nn.Linear(z_dim, hidden_size)
        if c_dim:
            self.fc_c = nn.Linear(c_dim, hidden_size)
        self.block0 = ResnetBlockFC(hidden_size)
        self.block1 = ResnetBlockFC(hidden_size)
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p: torch.Tensor, c: torch.Tensor,
                z: torch.Tensor | None = None) -> torch.Tensor:
        B = c.shape[0]
        net = c
        if self.z_dim:
            zz = z if z is not None else c.new_zeros((B, self.z_dim))
            net = torch.cat([zz, c], -1)
        vol = self.fc_in(net).reshape(B, 256, 4, 4, 4)       # NCDHW
        for i in range(3):
            n = vol.shape[-1]
            # flax's SAME transpose: the first 2n of torch's 2n + 1 outputs
            vol = getattr(self, f"convtrp_{i}")(F.relu(vol))[
                :, :, :2 * n, :2 * n, :2 * n]                # 4 -> 8 -> 16 -> 32
        # torch grid coords 2p map [-0.5, 0.5] to [-1, 1]; ours take p + 0.5
        feat = trilinear_grid_sample(vol.permute(0, 2, 3, 4, 1), p + 0.5)
        net = self.fc_f(F.relu(feat)) + self.fc_p(p)
        if self.z_dim:
            net = net + self.fc_z(zz)[:, None]
        if self.c_dim:
            net = net + self.fc_c(c)[:, None]
        net = self.block1(self.block0(net))
        return self.fc_out(F.relu(net))[..., 0]


class FeatureDecoder(nn.Module):
    """2D-feature-map legacy decoder (`legacy.py:73-125`): p [B, T, 3],
    c a channel-last map [B, H, W, c_dim], z [B, z_dim] or None (zeros) ->
    logits [B, T]. The points are perspective-projected into the map by a
    latent-conditioned affine transform."""

    def __init__(self, z_dim: int = 128, c_dim: int = 128,
                 hidden_size: int = 256):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        self.affine = AffineLayer(c_dim)
        self.fc_p1 = nn.Linear(3, hidden_size)
        self.fc_p2 = nn.Linear(3, hidden_size)
        if z_dim:
            self.fc_z = nn.Linear(z_dim, hidden_size)
        self.fc_c2 = nn.Linear(c_dim, hidden_size)
        self.fc_c1 = nn.Linear(c_dim, hidden_size)
        for i in range(4):
            self.add_module(f"block{i}", ResnetBlockFC(hidden_size))
        self.fc_out = nn.Linear(hidden_size, 1)

    def forward(self, p: torch.Tensor, c: torch.Tensor,
                z: torch.Tensor | None = None) -> torch.Tensor:
        B = p.shape[0]
        c1 = c.reshape(B, -1, self.c_dim).amax(1)                # [B, c_dim]
        Ap = self.affine(c1, p)                                  # [B, T, 3]
        # perspective divide; torch grid coords 2 Ap2 -> ours Ap2 + 0.5
        Ap2 = Ap[..., :2] / (Ap[..., 2:].abs() + 1e-5)
        c2 = plane_sample(c, Ap2 + 0.5)                          # [B, T, c_dim]
        net = self.fc_p1(p) + self.fc_p2(Ap)
        if self.z_dim:
            zz = z if z is not None else p.new_zeros((B, self.z_dim))
            net = net + self.fc_z(zz)[:, None]
        net = net + (self.fc_c2(c2) + self.fc_c1(c1)[:, None])
        for i in range(4):
            net = getattr(self, f"block{i}")(net)
        return self.fc_out(F.relu(net))[..., 0]
