"""Implicit networks: ConvONet (plane type)."""

from if_defense_tpu_torch.implicit.convonet import (
    ConvOccupancyNetwork,
    LocalDecoder,
    LocalPoolPointnet,
)
from if_defense_tpu_torch.implicit.layers import ResnetBlockFC
from if_defense_tpu_torch.implicit.unet2d import UNet2D

__all__ = [
    "ConvOccupancyNetwork",
    "LocalDecoder",
    "LocalPoolPointnet",
    "ResnetBlockFC",
    "UNet2D",
]
