"""PU-Net point upsampler, the DUP-Net restoration stage (port of
`if_defense_tpu/defense/punet.py`).

4 set-abstraction levels (npoint, /2, /4, /8 centres, radii .05/.1/.2/.3,
32 samples, MLPs 32-32-64 / 64-64-128 / 128-128-256 / 256-256-512), 3
feature propagations (3-NN inverse-distance interpolation + MLP to 64) back
to the input resolution, concat [xyz, l1, fp2, fp3, fp4] (259 channels),
`up_ratio` parallel expansion MLPs 256-128, then 128-64 and a 64-3 head.
No batch norm, so a SharedMLP is Dense + ReLU.

Submodules carry flax's automatic names (`PUNetSA_0..3`, `PUNetFP_0..2`,
`SharedMLP_i`, each with `Dense_j`), so `utils.params_io.params_from_jax`
maps the JAX weights file (`weights/punet_1024_up4.npz`) onto them.

FPS and ball query go through `ops.farthest_point_sample` /
`ops.query_ball_point`: kernels B5 and B6 on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from if_defense_tpu_torch.ops import (
    farthest_point_sample,
    index_points,
    knn_points,
    query_ball_point,
)


class SharedMLP(nn.Module):
    """Per-point Dense(+ReLU) stack; `activate_last=False` for the head."""

    def __init__(self, in_dim: int, features: tuple,
                 activate_last: bool = True):
        super().__init__()
        self.n = len(features)
        self.activate_last = activate_last
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", nn.Linear(in_dim, f))
            in_dim = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if self.activate_last or i < self.n - 1:
                x = torch.relu(x)
        return x


class PUNetSA(nn.Module):
    """Set abstraction: FPS centres, ball-query grouping, MLP, max-pool."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_dim: int, mlp: tuple):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.SharedMLP_0 = SharedMLP(in_dim, mlp)

    def forward(self, xyz, feats):
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
        idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
        grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
        if feats is not None:
            grouped = torch.cat([grouped, index_points(feats, idx)], dim=-1)
        h = self.SharedMLP_0(grouped)                     # [B, S, ns, C]
        return new_xyz, h.amax(dim=2)


class PUNetFP(nn.Module):
    """3-NN inverse-distance feature interpolation + MLP."""

    def __init__(self, in_dim: int, mlp: tuple):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(in_dim, mlp)

    def forward(self, unknown_xyz, known_xyz, known_feats):
        # stable sort: ties to the lower index, as lax.top_k
        idx, dists = knn_points(3, known_xyz, unknown_xyz, return_dist=True)
        w = 1.0 / (dists + 1e-8)
        w = w / w.sum(dim=-1, keepdim=True)
        gathered = index_points(known_feats, idx)         # [B, N, 3, C]
        return self.SharedMLP_0((gathered * w[..., None]).sum(dim=2))


class PUNet(nn.Module):
    """Input [B, npoint, 3] -> upsampled [B, npoint * up_ratio, 3]."""

    def __init__(self, npoint: int = 1024, up_ratio: int = 4):
        super().__init__()
        self.up_ratio = up_ratio
        mlps = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
        radii = (0.05, 0.1, 0.2, 0.3)
        in_dim = 0
        for k in range(4):
            setattr(self, f"PUNetSA_{k}", PUNetSA(
                npoint // 2**k, radii[k], 32, in_dim + 3, mlps[k]))
            in_dim = mlps[k][-1]
        for k in range(3):
            setattr(self, f"PUNetFP_{k}", PUNetFP(mlps[k + 1][-1], (64,)))
        feat_dim = 3 + mlps[0][-1] + 3 * 64                # 259
        for i in range(up_ratio):
            setattr(self, f"SharedMLP_{i}", SharedMLP(feat_dim, (256, 128)))
        setattr(self, f"SharedMLP_{up_ratio}", SharedMLP(128, (64,)))
        setattr(self, f"SharedMLP_{up_ratio + 1}",
                SharedMLP(64, (3,), activate_last=False))

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        l_xyz, l_feats = [xyz], [None]
        for k in range(4):
            lx, lf = getattr(self, f"PUNetSA_{k}")(l_xyz[k], l_feats[k])
            l_xyz.append(lx)
            l_feats.append(lf)
        up = [getattr(self, f"PUNetFP_{k}")(xyz, l_xyz[k + 2], l_feats[k + 2])
              for k in range(3)]
        feats = torch.cat([xyz, l_feats[1], *up], dim=-1)   # [B, N, 259]
        r_feats = torch.cat([getattr(self, f"SharedMLP_{i}")(feats)
                             for i in range(self.up_ratio)], dim=1)
        h = getattr(self, f"SharedMLP_{self.up_ratio}")(r_feats)
        return getattr(self, f"SharedMLP_{self.up_ratio + 1}")(h)
