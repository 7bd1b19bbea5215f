"""Victim classifiers (port of `if_defense_tpu/models/`).

All share one API: `nn.Module`s whose `forward(xyz, mask=None, draw=None)`
takes channel-last `[B, N, 3]` clouds (and an optional `[B, N]` validity
mask) and returns `(logits [B, num_classes], aux dict)`; aux carries
PointNet's transform matrices for the orthogonality regulariser and is
empty for the others. Training mode is the module's (`model.train()` /
`model.eval()`); in training, `draw` gives the dropout layers' keep masks
(`models.common.dropout`).
"""

from if_defense_tpu_torch.models.dgcnn import DGCNN
from if_defense_tpu_torch.models.pointconv import PointConvDensityClsSsg
from if_defense_tpu_torch.models.pointnet import (
    PointNetCls,
    feature_transform_regularizer,
)
from if_defense_tpu_torch.models.pointnet2 import PointNet2ClsSsg
from if_defense_tpu_torch.models.rscnn import RSCNN

MODEL_REGISTRY = {
    "pointnet": PointNetCls,
    "pointnet2": PointNet2ClsSsg,
    "dgcnn": DGCNN,
    "pointconv": PointConvDensityClsSsg,
    "rscnn": RSCNN,
}


def build_model(name: str, num_classes: int = 40, **kwargs):
    """Instantiate a victim classifier by registry name."""
    try:
        cls = MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; choose from {sorted(MODEL_REGISTRY)}"
        ) from None
    return cls(num_classes=num_classes, **kwargs)


__all__ = [
    "PointNetCls",
    "PointNet2ClsSsg",
    "DGCNN",
    "PointConvDensityClsSsg",
    "RSCNN",
    "feature_transform_regularizer",
    "MODEL_REGISTRY",
    "build_model",
]
