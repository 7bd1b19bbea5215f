"""Point-cloud ops and the CUDA kernel wrappers.

The kernel wrappers (`cuda_interp`, `cuda_repulsion`, `cuda_fps`,
`cuda_ballquery`, `cuda_scatter`) are imported where they are used: their
libraries build on first use, on a machine with `nvcc` and a card.
"""

from if_defense_tpu_torch.ops.distances import (
    chamfer_distance,
    hausdorff_distance,
)
from if_defense_tpu_torch.ops.interp import (
    bilinear_plane_sample,
    cached_bilinear_sample,
    normalize_coordinate,
    plane_corner_features,
    plane_features,
    plane_sample,
    trilinear_grid_sample,
)
from if_defense_tpu_torch.ops.metrics3d import compute_iou
from if_defense_tpu_torch.ops.normalize import (
    normalize_unit_cube,
    normalize_unit_sphere,
)
from if_defense_tpu_torch.ops.pointops import (
    farthest_point_sample,
    farthest_point_sample_plain,
    gather_neighbors,
    index_points,
    knn_points,
    knn_self,
    pairwise_self_distance,
    query_ball_point,
    query_ball_point_plain,
    square_distance,
)
from if_defense_tpu_torch.ops.scatter import (
    cell_csr,
    pooled_max_by_cell,
    pooled_mean_by_cell,
    scatter_max_2d,
    scatter_mean_2d,
)

__all__ = [
    "chamfer_distance",
    "hausdorff_distance",
    "compute_iou",
    "bilinear_plane_sample",
    "cached_bilinear_sample",
    "normalize_coordinate",
    "plane_corner_features",
    "plane_features",
    "plane_sample",
    "trilinear_grid_sample",
    "normalize_unit_cube",
    "normalize_unit_sphere",
    "farthest_point_sample",
    "farthest_point_sample_plain",
    "gather_neighbors",
    "index_points",
    "knn_points",
    "knn_self",
    "pairwise_self_distance",
    "query_ball_point",
    "query_ball_point_plain",
    "square_distance",
    "cell_csr",
    "pooled_max_by_cell",
    "pooled_mean_by_cell",
    "scatter_max_2d",
    "scatter_mean_2d",
]
