"""Implicit networks: ConvONet (planes and/or a grid volume), ONet (the
decoder registry, the latent encoder) and the legacy decoders; the names
the JAX package's `implicit/__init__` exports, and the port's layers.
`PointConvONet` (the PointNet++ point-feature ConvONet) is imported from
`implicit.pointnetpp_encoder`, as in the JAX package: it builds on
`models.pointnet2`, whose `models.common` imports `implicit.layers`."""

from if_defense_tpu_torch.implicit.convonet import (
    ConvOccupancyNetwork,
    LocalDecoder,
    LocalPoolPointnet,
    PatchLocalPoolPointnet,
)
from if_defense_tpu_torch.implicit.layers import (
    BatchNorm,
    CBatchNorm,
    CResnetBlockConv1d,
    ResnetBlockConv1d,
    ResnetBlockFC,
)
from if_defense_tpu_torch.implicit.legacy import FeatureDecoder, VoxelDecoder
from if_defense_tpu_torch.implicit.onet import (
    DECODER_REGISTRY,
    DecoderCBatchNorm,
    LatentEncoder,
    OccupancyNetwork,
    ResnetPointnet,
)
from if_defense_tpu_torch.implicit.unet2d import UNet2D
from if_defense_tpu_torch.implicit.unet3d import UNet3D

__all__ = [
    "BatchNorm",
    "CBatchNorm",
    "CResnetBlockConv1d",
    "ConvOccupancyNetwork",
    "DECODER_REGISTRY",
    "DecoderCBatchNorm",
    "FeatureDecoder",
    "LatentEncoder",
    "LocalDecoder",
    "LocalPoolPointnet",
    "OccupancyNetwork",
    "PatchLocalPoolPointnet",
    "ResnetBlockConv1d",
    "ResnetBlockFC",
    "ResnetPointnet",
    "UNet2D",
    "UNet3D",
    "VoxelDecoder",
]
