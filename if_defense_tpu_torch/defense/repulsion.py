"""Repulsion loss pushing restored points toward uniform spacing (port of
`if_defense_tpu/defense/repulsion.py`).

k=5 nearest neighbours (self excluded, graph without gradient), loss = mean
over points and neighbours of (radius - dist) * exp(-(dist/h)^2) with
radius 0.07, h 0.03 and an eps floor of 1e-12 before the sqrt.

The plain versions of the CUDA kernels live here:
- `repulsion_loss_threshold` (B1): exact selection by each row's k-th
  smallest distance, with fractional weights at ties;
- `repulsion_mask` (B2) and `repulsion_loss_masked` (B3).
The `*_auto` dispatchers launch the kernels for CUDA tensors and take these
for CPU tensors. Unlike the JAX package on the CPU (approx_max_k on bf16
distances unless the fused kernel is forced), the port's CPU path is the
exact selection the kernels compute.

`repulsion_knn` is always exact (a stable sort, ties to the lower index):
the JAX package's `approx_max_k` selection (its `exact=False`) is a TPU
speed device and is not ported.
"""

from __future__ import annotations

import torch

from if_defense_tpu_torch.ops import gather_neighbors, knn_self

_FAR = 1e30    # self-distance, as the Pallas kernels' _INF


def repulsion_knn(pc: torch.Tensor, nn_size: int = 5) -> torch.Tensor:
    """Exact repulsion neighbour graph `[B, N, k]`, without gradient."""
    with torch.no_grad():
        return knn_self(nn_size, pc)


def repulsion_loss_with_idx(pc: torch.Tensor, idx: torch.Tensor,
                            radius: float = 0.07, h: float = 0.03,
                            eps: float = 1e-12) -> torch.Tensor:
    """Repulsion loss against a precomputed neighbour graph, `[B]`."""
    grouped = gather_neighbors(pc, idx)                  # [B, N, k, 3]
    diff = grouped - pc[:, :, None, :]
    dist = (diff * diff).sum(-1).clamp_min(eps).sqrt()   # [B, N, k]
    uniform = (radius - dist) * torch.exp(-((dist / h) ** 2))
    return uniform.mean(dim=(1, 2))


def repulsion_loss(pc: torch.Tensor, nn_size: int = 5, radius: float = 0.07,
                   h: float = 0.03, eps: float = 1e-12) -> torch.Tensor:
    """Per-example repulsion loss over the exact k-NN graph with ties
    broken by index (JAX's `exact=True`), `[B, N, 3]` -> `[B]`."""
    idx = repulsion_knn(pc, nn_size)
    return repulsion_loss_with_idx(pc, idx, radius, h, eps)


def pairwise_d2(pc: torch.Tensor) -> torch.Tensor:
    """Exact f32 `[B, N, N]` squared distances from coordinate differences,
    summed x, y, z in that order (the kernels' bits); self -> 1e30."""
    p = pc.float()
    dx, dy, dz = (p[:, :, None, :] - p[:, None, :, :]).unbind(-1)
    d2 = (dx * dx + dy * dy) + dz * dz
    eye = torch.eye(pc.shape[1], dtype=torch.bool, device=pc.device)
    return d2.masked_fill(eye, _FAR)


def _term(d2: torch.Tensor, radius: float, h: float,
          eps: float) -> torch.Tensor:
    """(r - d) exp(-(d/h)^2), d = sqrt(max(d2, eps)); no gradient inside
    eps (as the kernels)."""
    d = torch.where(d2 > eps, d2, torch.full_like(d2, eps)).sqrt()
    return (radius - d) * torch.exp(-((d / h) ** 2))


def _threshold_weights(d2: torch.Tensor, k: int) -> torch.Tensor:
    """1 below each row's k-th smallest d2 (with multiplicity), (k - n_lt)
    / n_eq at it, 0 above."""
    t = d2.kthvalue(k, dim=-1, keepdim=True).values
    lt = d2 < t
    eq = d2 == t
    n_lt = lt.sum(-1, keepdim=True).float()
    n_eq = eq.sum(-1, keepdim=True).float()
    return lt.float() + eq.float() * ((k - n_lt) / n_eq.clamp_min(1.0))


def repulsion_loss_threshold(pc: torch.Tensor, nn_size: int = 5,
                             radius: float = 0.07, h: float = 0.03,
                             eps: float = 1e-12) -> torch.Tensor:
    """Plain version of kernel B1, `[B, N, 3]` (f32 or bf16) -> f32 `[B]`.

    Exact k-NN selection per row with fractional tie weights, computed in
    f32; the gradient flows through the distances, not the selection.
    """
    N = pc.shape[1]
    d2 = pairwise_d2(pc)
    with torch.no_grad():
        w = _threshold_weights(d2, nn_size)
    return (w * _term(d2, radius, h, eps)).sum(dim=(1, 2)) / (N * nn_size)


def repulsion_mask(pc: torch.Tensor, nn_size: int = 5) -> torch.Tensor:
    """Plain version of kernel B2: int8 `[B, N, N]`, 1 where d2 <= the row's
    k-th smallest (every tie included), diagonal 0."""
    with torch.no_grad():
        d2 = pairwise_d2(pc)
        t = d2.kthvalue(nn_size, dim=-1, keepdim=True).values
        return (d2 <= t).to(torch.int8)


def repulsion_loss_masked(pc: torch.Tensor, mask: torch.Tensor,
                          nn_size: int = 5, radius: float = 0.07,
                          h: float = 0.03, eps: float = 1e-12) -> torch.Tensor:
    """Plain version of kernel B3: the loss against a cached int8 mask,
    divided by N k whatever the row counts; gradient to the points only."""
    N = pc.shape[1]
    w = mask.detach().float()
    term = _term(pairwise_d2(pc), radius, h, eps)
    return (w * term).sum(dim=(1, 2)) / (N * nn_size)


def repulsion_loss_auto(pc: torch.Tensor, nn_size: int = 5,
                        radius: float = 0.07, h: float = 0.03,
                        eps: float = 1e-12) -> torch.Tensor:
    """B1 for CUDA tensors, its plain version for CPU tensors."""
    if pc.is_cuda:
        from if_defense_tpu_torch.ops.cuda_repulsion import repulsion_loss_cuda

        return repulsion_loss_cuda(pc, nn_size, radius, h, eps)
    return repulsion_loss_threshold(pc, nn_size, radius, h, eps)


def repulsion_mask_auto(pc: torch.Tensor, nn_size: int = 5) -> torch.Tensor:
    """B2 for CUDA tensors, its plain version for CPU tensors."""
    if pc.is_cuda:
        from if_defense_tpu_torch.ops.cuda_repulsion import repulsion_mask_cuda

        return repulsion_mask_cuda(pc, nn_size)
    return repulsion_mask(pc, nn_size)


def repulsion_loss_masked_auto(pc: torch.Tensor, mask: torch.Tensor,
                               nn_size: int = 5, radius: float = 0.07,
                               h: float = 0.03,
                               eps: float = 1e-12) -> torch.Tensor:
    """B3 for CUDA tensors, its plain version for CPU tensors."""
    if pc.is_cuda:
        from if_defense_tpu_torch.ops.cuda_repulsion import (
            repulsion_loss_masked_cuda,
        )

        return repulsion_loss_masked_cuda(pc, mask, nn_size, radius, h, eps)
    return repulsion_loss_masked(pc, mask, nn_size, radius, h, eps)
