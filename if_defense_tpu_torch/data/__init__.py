"""Data layer: the npz interchange schema and ModelNet40 dataset pipelines."""

from if_defense_tpu_torch.data.augment import (
    jitter_point_cloud,
    rotate_point_cloud,
    translate_point_cloud,
)
from if_defense_tpu_torch.data.modelnet40 import (
    ModelNet40,
    ModelNet40Attack,
    ModelNet40Hybrid,
    ModelNet40Normal,
    ModelNet40NormalAttack,
    batch_iterator,
)
from if_defense_tpu_torch.data.npz import NpzData, load_npz, save_npz

__all__ = [
    "NpzData",
    "load_npz",
    "save_npz",
    "ModelNet40",
    "ModelNet40Hybrid",
    "ModelNet40Normal",
    "ModelNet40Attack",
    "ModelNet40NormalAttack",
    "batch_iterator",
    "rotate_point_cloud",
    "jitter_point_cloud",
    "translate_point_cloud",
]
