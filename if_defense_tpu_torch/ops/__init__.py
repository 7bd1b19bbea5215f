"""Point-cloud ops and the CUDA kernel wrappers.

The kernel wrappers (`cuda_interp`, `cuda_repulsion`) are imported where
they are used: their libraries build on first use, on a machine with
`nvcc` and a card.
"""

from if_defense_tpu_torch.ops.interp import (
    bilinear_plane_sample,
    cached_bilinear_sample,
    plane_corner_features,
    plane_sample,
)
from if_defense_tpu_torch.ops.normalize import (
    normalize_unit_cube,
    normalize_unit_sphere,
)
from if_defense_tpu_torch.ops.pointops import (
    gather_neighbors,
    index_points,
    knn_points,
    knn_self,
    square_distance,
)
from if_defense_tpu_torch.ops.scatter import pooled_max_by_cell, scatter_mean_2d

__all__ = [
    "bilinear_plane_sample",
    "cached_bilinear_sample",
    "plane_corner_features",
    "plane_sample",
    "normalize_unit_cube",
    "normalize_unit_sphere",
    "gather_neighbors",
    "index_points",
    "knn_points",
    "knn_self",
    "square_distance",
    "pooled_max_by_cell",
    "scatter_mean_2d",
]
