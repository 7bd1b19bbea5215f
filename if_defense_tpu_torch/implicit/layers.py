"""Shared implicit-network layers (port of `ResnetBlockFC` in
`if_defense_tpu/implicit/layers.py`)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class ResnetBlockFC(nn.Module):
    """FC ResNet block: x + fc_1(relu(fc_0(relu(x)))), with a bias-free
    linear shortcut when the width changes. Submodule names follow the flax
    module's, so `utils.params_io.params_from_jax` maps keys one to one."""

    def __init__(self, size_in: int, size_out: int | None = None,
                 size_h: int | None = None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = (nn.Linear(size_in, size_out, bias=False)
                         if size_in != size_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x))))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx
