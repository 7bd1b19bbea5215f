"""Implicit networks: ConvONet (plane types) and ONet (CBN decoder)."""

from if_defense_tpu_torch.implicit.convonet import (
    ConvOccupancyNetwork,
    LocalDecoder,
    LocalPoolPointnet,
)
from if_defense_tpu_torch.implicit.layers import (
    BatchNorm,
    CBatchNorm,
    CResnetBlockConv1d,
    ResnetBlockConv1d,
    ResnetBlockFC,
)
from if_defense_tpu_torch.implicit.onet import (
    DecoderCBatchNorm,
    OccupancyNetwork,
    ResnetPointnet,
)
from if_defense_tpu_torch.implicit.unet2d import UNet2D

__all__ = [
    "BatchNorm",
    "CBatchNorm",
    "CResnetBlockConv1d",
    "ConvOccupancyNetwork",
    "DecoderCBatchNorm",
    "LocalDecoder",
    "LocalPoolPointnet",
    "OccupancyNetwork",
    "ResnetBlockConv1d",
    "ResnetBlockFC",
    "ResnetPointnet",
    "UNet2D",
]
