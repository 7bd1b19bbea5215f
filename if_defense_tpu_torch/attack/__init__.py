"""White-box attacks: the CW family, the FGM family and saliency Drop
(port of `if_defense_tpu/attack/`).

Every attack works on channel-last [B, K, 3] clouds through a
`logits_fn(pc) -> [B, num_classes]` closure over a victim in eval mode
with autograd on (Drop's takes `(pc, mask)`), so any victim of the
registry can be attacked. Random draws come from a `torch.Generator`, or
from the caller through each attack's `draws` seam.
"""

from if_defense_tpu_torch.attack.clip import (
    clip_points_l2,
    clip_points_linf,
    project_inner_clip_linf,
    project_inner_points,
)
from if_defense_tpu_torch.attack.cw import cw_add, cw_knn, cw_perturb
from if_defense_tpu_torch.attack.cw_cluster import cw_add_cluster, cw_add_object
from if_defense_tpu_torch.attack.drop import saliency_drop
from if_defense_tpu_torch.attack.fgm import fgm, ifgm, mifgm, pgd
from if_defense_tpu_torch.attack.losses import (
    chamfer_dist,
    chamfer_knn_dist,
    cross_entropy_adv_loss,
    farthest_dist,
    hausdorff_dist,
    knn_dist,
    l2_dist,
    logits_adv_loss,
)

__all__ = [
    "logits_adv_loss",
    "cross_entropy_adv_loss",
    "l2_dist",
    "chamfer_dist",
    "hausdorff_dist",
    "knn_dist",
    "chamfer_knn_dist",
    "farthest_dist",
    "clip_points_l2",
    "clip_points_linf",
    "project_inner_points",
    "project_inner_clip_linf",
    "cw_perturb",
    "cw_add",
    "cw_knn",
    "cw_add_cluster",
    "cw_add_object",
    "fgm",
    "ifgm",
    "mifgm",
    "pgd",
    "saliency_drop",
]
