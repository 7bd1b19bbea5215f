"""Set distances between point clouds, Chamfer and Hausdorff (port of
`if_defense_tpu/ops/distances.py`).

Both directions are returned per example, on squared L2 distances: means
(Chamfer) or maxes (Hausdorff) over the point axis of each point's
distance to the nearest point of the other set.
"""

from __future__ import annotations

import torch

from if_defense_tpu_torch.ops.pointops import square_distance


def chamfer_distance(adv: torch.Tensor, ori: torch.Tensor):
    """Bidirectional Chamfer distance of [B, N1, 3] and [B, N2, 3] clouds.

    Returns:
        (adv2ori [B], ori2adv [B]).
    """
    d = square_distance(adv, ori)                            # [B, N1, N2]
    return d.amin(dim=2).mean(dim=1), d.amin(dim=1).mean(dim=1)


def hausdorff_distance(adv: torch.Tensor, ori: torch.Tensor):
    """Bidirectional one-sided Hausdorff distances.

    Returns:
        (adv2ori [B], ori2adv [B]).
    """
    d = square_distance(adv, ori)
    return d.amin(dim=2).amax(dim=1), d.amin(dim=1).amax(dim=1)
