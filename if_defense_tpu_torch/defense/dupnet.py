"""DUP-Net defense: SOR -> resample to a fixed size -> frozen PU-Net
(port of `if_defense_tpu/defense/dupnet.py`).

Clouds with more SOR inliers than `npoint` are randomly subsampled, clouds
with fewer are cyclically duplicated, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from if_defense_tpu_torch.defense.punet import PUNet
from if_defense_tpu_torch.defense.sor import sor_defense
from if_defense_tpu_torch.ops import index_points


def process_data_fixed(pc: torch.Tensor, mask: torch.Tensor, npoint: int,
                       generator: torch.Generator | None = None,
                       u: torch.Tensor | None = None) -> torch.Tensor:
    """Resample a masked cloud to exactly `npoint` valid points.

    Valid points first in a random order (a stable sort of
    2 (1 - mask) + u), then the first `npoint` of them, repeated
    cyclically when fewer are valid.

    Args:
        pc: [B, K, 3]; mask: [B, K] (1 = valid).
        generator: source of the uniforms (on pc's device).
        u: optional [B, K] uniforms in [0, 1) to use instead of drawing
            (tests feed JAX's).
    Returns:
        [B, npoint, 3]
    """
    B, K, _ = pc.shape
    if u is None:
        u = torch.rand((B, K), generator=generator, device=pc.device)
    order = torch.argsort((1.0 - mask) * 2.0 + u, dim=-1, stable=True)
    n = mask.sum(dim=-1).to(torch.long).clamp(min=1)
    j = torch.arange(npoint, device=pc.device)
    return index_points(pc, torch.gather(order, 1, j[None, :] % n[:, None]))


class DUPNet(nn.Module):
    """SOR + PU-Net with frozen pretrained parameters.

    Usage:
        dup = DUPNet(sor_k=2, sor_alpha=1.1, npoint=1024, up_ratio=4)
        dup.pu_net.load_state_dict(
            params_from_jax(load_params_npz(path), dup.pu_net))
        out = dup(pc, generator)   # [B, npoint * up_ratio, 3]
    """

    def __init__(self, sor_k: int = 2, sor_alpha: float = 1.1,
                 npoint: int = 1024, up_ratio: int = 4):
        super().__init__()
        self.sor_k, self.sor_alpha, self.npoint = sor_k, sor_alpha, npoint
        self.pu_net = PUNet(npoint=npoint, up_ratio=up_ratio)

    def forward(self, pc: torch.Tensor,
                generator: torch.Generator | None = None,
                u: torch.Tensor | None = None) -> torch.Tensor:
        pc, mask = sor_defense(pc, self.sor_k, self.sor_alpha)
        proc = process_data_fixed(pc, mask, self.npoint, generator, u)
        return self.pu_net(proc)
