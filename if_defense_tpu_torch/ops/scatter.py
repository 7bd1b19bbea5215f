"""Batched scatter-reduce onto flat cell grids (port of
`if_defense_tpu/ops/scatter.py`).

The JAX package writes these scatter-free for the TPU (one-hot matmul,
pairwise same-cell mask); on the GPU PyTorch's scatter ops are the direct
form. Neither was a Pallas kernel. The encoder's scatter-mean and pooled
max have kernels of their own on the card (`ops/cuda_scatter.py`):
`scatter_add_` sums there with atomics (the pooled max's in `gather`'s
backward), in an order that changes from run to run, and the encoder's
planes, hence a seeded defense or training run, would not repeat. The
kernels read each cloud's cells as a CSR built on the card
(`ops/cuda_csr.py`); `cell_csr` builds it once for an index, and the
calls on that index take it as `csr=`.
"""

from __future__ import annotations

import torch


def scatter_mean_2d_plain(feat: torch.Tensor, index: torch.Tensor,
                          num_cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `scatter_mean_2d`, with `scatter_add_`: on the
    CPU it adds each cell's points one after another in point order.
    -> (means [B, num_cells, C], each cell's count [B, num_cells])."""
    B, N, C = feat.shape
    idx = index.long()
    sums = feat.new_zeros(B, num_cells, C).scatter_add_(
        1, idx[..., None].expand(-1, -1, C), feat)
    counts = feat.new_zeros(B, num_cells).scatter_add_(
        1, idx, feat.new_ones(B, N))
    return sums / counts.clamp_min(1.0)[..., None], counts


def cell_csr(index: torch.Tensor, num_cells: int):
    """The CSR of a [B, N] cell index that `scatter_mean_2d`,
    `pooled_max_by_cell` and `pooled_mean_by_cell` take as `csr=`, so
    that the calls on one index share one build: built on the card for a
    CUDA index (one launch), None for a CPU one (the plain versions need
    none)."""
    if not index.is_cuda:
        return None
    from if_defense_tpu_torch.ops.cuda_csr import build_csr

    return build_csr(index, num_cells)


class _ScatterMean(torch.autograd.Function):
    """The scatter-mean with a gather for its backward,
    `grad[b, n] = grad_out[b, idx[b, n]] / count`: no scatter, so no race.
    Forward: the kernel for CUDA tensors, the plain version for CPU ones.
    On the card the CSR is the one source of the cells: the backward
    gathers with the index the kernel read from it."""

    @staticmethod
    def forward(ctx, feat, index, num_cells, csr):
        if feat.is_cuda:
            from if_defense_tpu_torch.ops.cuda_scatter import scatter_mean_cuda

            out, counts = scatter_mean_cuda(feat, index, num_cells, csr)
            if csr is not None:
                index = csr.index        # the cells the kernel read
        else:
            out, cell_counts = scatter_mean_2d_plain(feat, index, num_cells)
            counts = torch.gather(cell_counts, 1, index.long())
        ctx.save_for_backward(index, counts)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        index, counts = ctx.saved_tensors
        C = grad_out.shape[-1]
        grad = torch.gather(grad_out, 1,
                            index.long()[..., None].expand(-1, -1, C))
        return grad / counts[..., None], None, None, None


def scatter_mean_2d(feat: torch.Tensor, index: torch.Tensor,
                    num_cells: int, csr=None) -> torch.Tensor:
    """Per-batch mean-scatter of point features into grid cells, each
    cell's points added in point order (the same bits on the card and the
    CPU, run after run).

    Args:
        feat: [B, N, C], float32 on a CUDA device (the kernel's only
            dtype; TypeError otherwise), any floating dtype on the CPU;
        index: [B, N] int cell index in [0, num_cells);
        csr: `cell_csr(index, num_cells)` where the caller shares one
            (on the card; built here when None). Where given, the card
            reads the cells from it, both ways, and `index` only for its
            shape.
    Returns:
        [B, num_cells, C]; empty cells are zero.
    """
    return _ScatterMean.apply(feat, index, num_cells, csr)


def pooled_max_by_cell_plain(feat: torch.Tensor, index: torch.Tensor,
                             num_cells: int) -> torch.Tensor:
    """The plain version of `pooled_max_by_cell`: `scatter_reduce` amax
    into a -inf fill, then `gather` back. Under autograd on the CPU its
    backward adds each cell's output gradients in point order
    (`gather`'s backward, a `scatter_add_`) and shares them evenly among
    the points equal to the max (`scatter_reduce`'s amax formula)."""
    B, N, C = feat.shape
    idx = index.long()[..., None].expand(-1, -1, C)
    cell_max = feat.new_full((B, num_cells, C), -torch.inf).scatter_reduce(
        1, idx, feat, reduce="amax", include_self=True)
    return torch.gather(cell_max, 1, idx)


class _PooledMax(torch.autograd.Function):
    """The pooled max on the card, both ways by the kernels."""

    @staticmethod
    def forward(ctx, feat, index, num_cells, csr):
        from if_defense_tpu_torch.ops.cuda_scatter import pooled_max_cuda

        out, state = pooled_max_cuda(feat, index, num_cells, csr)
        ctx.state = state
        ctx.save_for_backward(feat, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from if_defense_tpu_torch.ops.cuda_scatter import (
            pooled_max_backward_cuda,
        )

        feat, out = ctx.saved_tensors
        return (pooled_max_backward_cuda(grad_out, feat, out, ctx.state),
                None, None, None)


def pooled_max_by_cell(feat: torch.Tensor, index: torch.Tensor,
                       num_cells: int, csr=None) -> torch.Tensor:
    """Per-POINT max over all points sharing the same cell (scatter_max and
    gather back, the ConvONet encoder's pool_local), each cell's points
    taken in point order both ways (the same bits on the card and the CPU,
    run after run); the gradient of a cell is shared evenly among the
    points equal to its max.

    Args:
        feat: [B, N, C], float32 on a CUDA device (the kernels' only
            dtype; TypeError otherwise), any floating dtype on the CPU;
        index: [B, N] int cell index in [0, num_cells);
        csr: `cell_csr(index, num_cells)` where the caller shares one
            (on the card; built here when None).
    Returns:
        [B, N, C]
    """
    if feat.is_cuda:
        return _PooledMax.apply(feat, index, num_cells, csr)
    return pooled_max_by_cell_plain(feat, index, num_cells)


def pooled_mean_by_cell(feat: torch.Tensor, index: torch.Tensor,
                        num_cells: int, csr=None) -> torch.Tensor:
    """Per-POINT mean over all points sharing the same cell (scatter_mean
    and gather back, PatchLocalPoolPointnet's scatter_type 'mean').

    Args:
        feat: [B, N, C]; index: [B, N] in [0, num_cells); csr as in
            `scatter_mean_2d`.
    Returns:
        [B, N, C]
    """
    C = feat.shape[-1]
    cell_mean = scatter_mean_2d(feat, index, num_cells, csr)
    return torch.gather(cell_mean, 1, index.long()[..., None].expand(-1, -1, C))


def scatter_max_2d(feat: torch.Tensor, index: torch.Tensor,
                   num_cells: int) -> torch.Tensor:
    """Per-batch max-scatter of point features into grid cells, with
    torch_scatter 2.x's semantics: the max over the scattered features only
    (it can be negative); cells no point maps to are zero.

    Args:
        feat: [B, N, C]; index: [B, N] in [0, num_cells).
    Returns:
        [B, num_cells, C]
    """
    B, _, C = feat.shape
    idx = index.long()[..., None].expand(-1, -1, C)
    out = feat.new_full((B, num_cells, C), -torch.inf).scatter_reduce(
        1, idx, feat, reduce="amax", include_self=True)
    return torch.where(torch.isinf(out), torch.zeros_like(out), out)
