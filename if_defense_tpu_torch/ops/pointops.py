"""Point ops: pairwise distance, gather, exact kNN (port of the
`square_distance` / `index_points` / `knn_points` / `knn_self` /
`gather_neighbors` part of `if_defense_tpu/ops/pointops.py`).

FPS and ball query (Pallas kernels B5/B6 in the JAX package) are off the
ConvONet-Opt path and not ported yet.
"""

from __future__ import annotations

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance between every pair, expansion form
    ``|s|^2 - 2 s.d + |d|^2`` in full f32.

    Args:
        src: [B, N, C]; dst: [B, M, C]
    Returns:
        [B, N, M]
    """
    s2 = (src * src).sum(-1, keepdim=True)                   # [B, N, 1]
    d2 = (dst * dst).sum(-1, keepdim=True)                   # [B, M, 1]
    cross = torch.bmm(src, dst.transpose(1, 2))
    return s2 - 2.0 * cross + d2.transpose(1, 2)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: out[b, ..., c] = points[b, idx[b, ...], c].

    Args:
        points: [B, N, C]; idx: [B, ...] integer indices into the N axis.
    Returns:
        [B, ..., C]
    """
    B, _, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Grouped neighbour gather (the JAX package's one-hot MXU form is a
    TPU device choice; on the GPU a plain gather is exact and cheap)."""
    return index_points(points, idx)


def knn_points(k: int, xyz: torch.Tensor, query: torch.Tensor | None = None,
               exclude_self: bool = False, return_dist: bool = False):
    """Exact k-nearest-neighbour indices of `query` within `xyz`.

    The JAX package's `method="sort"`: a stable sort of the expansion-form
    distances, so ties go to the lower index as with `lax.top_k`.
    `exclude_self` drops the first hit (self, at distance ~0).

    Returns:
        idx [B, Q, k] (int64), optionally (idx, sqdist [B, Q, k]).
    """
    if query is None:
        query = xyz
    d = square_distance(query, xyz)                          # [B, Q, N]
    kk = k + 1 if exclude_self else k
    vals, idx = torch.sort(d, dim=-1, stable=True)
    vals, idx = vals[..., :kk], idx[..., :kk]
    if exclude_self:
        vals, idx = vals[..., 1:], idx[..., 1:]
    if return_dist:
        return idx, vals
    return idx


def knn_self(k: int, xyz: torch.Tensor, return_dist: bool = False):
    """kNN within a cloud excluding self (reference `pn_utils.knn_point`)."""
    return knn_points(k, xyz, exclude_self=True, return_dist=return_dist)
