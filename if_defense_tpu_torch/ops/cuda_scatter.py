"""Wrappers of the CUDA kernels of the encoder's per-cell reductions
(`csrc/scatter.cu`): the scatter-mean and the pooled max with its backward.

Replace no TPU kernel: the JAX package's `ops/scatter.py:20-56` writes the
scatter-mean as a one-hot matmul and the pooled max as a masked max over a
pairwise same-cell mask. The port's plain versions,
`ops.scatter.scatter_mean_2d_plain` and `pooled_max_by_cell_plain`, take
torch's scatters, whose atomics on the card add in an order that changes
from run to run (the pooled max's in `gather`'s backward). The kernels take
each cell's points in point order, the order the plain versions take them
in on the CPU, so they give those versions' bits on a CPU copy and the same
bits launch after launch. They read each cloud's cells as a CSR
(`ops/cuda_csr.py`), which a caller builds once for a plane index and hands
to every call on it (else each call builds its own). They take f32 tensors
on a CUDA device only; `ops.scatter` chooses between kernel and plain
version by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from if_defense_tpu_torch.ops import _build
from if_defense_tpu_torch.ops.cuda_csr import CSR, build_csr

# kernel launches, counted where they happen
launches = {"scatter_mean": 0, "pooled_max": 0, "pooled_max_backward": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def _check(what: str, feat: torch.Tensor, index: torch.Tensor,
           num_cells: int, csr: CSR | None) -> None:
    """Raise unless `feat` is [B, N, C] f32 on a CUDA device, `index` an
    integer [B, N] beside it and `csr`, where given, a CSR of `num_cells`
    cells of an index of that shape. Where a CSR is given it is the one
    source of the cells (the kernels and the scatter-mean's backward read
    its `index`); the range is checked by the CSR's kernel."""
    if feat.dtype != torch.float32:
        raise TypeError(f"features must be float32, not {feat.dtype}")
    if feat.dim() != 3:
        raise ValueError(f"features must be [B, N, C], not "
                         f"{tuple(feat.shape)}")
    B, N, _ = feat.shape
    if tuple(index.shape) != (B, N) or index.device != feat.device:
        raise ValueError(f"index must be [{B}, {N}] on the features' device")
    if index.dtype.is_floating_point or index.dtype == torch.bool:
        raise TypeError(f"index must be integer, not {index.dtype}")
    if num_cells < 1 or num_cells > 2**31 - 2:
        raise ValueError(f"num_cells={num_cells} out of range")
    if csr is not None and (csr.num_targets != num_cells
                            or csr.index.shape != index.shape):
        raise ValueError(f"the CSR of {csr.num_targets} cells x "
                         f"{tuple(csr.index.shape)} does not fit "
                         f"num_cells={num_cells} x {tuple(index.shape)}")
    if not feat.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors")


def scatter_mean_cuda(feat: torch.Tensor, index: torch.Tensor,
                      num_cells: int, csr: CSR | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cloud mean of `feat` [B, N, C] f32 over the points of each cell
    of `index` [B, N] (integers in [0, num_cells)), read from `csr` (its
    CSR, built here when not given). -> (means [B, num_cells, C], 0 in
    empty cells; each point's cell count [B, N] f32). The output's zeros
    are a memset; the kernel writes only the occupied cells. The range of
    `index` is checked on the card, with no host sync: an index outside
    it stops the CSR's kernel, and the CUDA error it leaves (as
    `scatter_add_`'s device assert does) raises at the next sync."""
    _check("scatter_mean_cuda", feat, index, num_cells, csr)
    csr = build_csr(index, num_cells) if csr is None else csr
    B, N, C = feat.shape
    out = torch.empty((B, num_cells, C), dtype=feat.dtype, device=feat.device)
    counts = torch.empty((B, N), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out, counts
    feat = feat.contiguous()
    fn = _build.bind("scatter", "ifdef_scatter_mean",
                     [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P])
    _build.launch("scatter", "scatter_mean", fn, (
        feat.data_ptr(), csr.index.data_ptr(),
        int(csr.index.dtype == torch.int64), csr.offsets.data_ptr(),
        csr.rows.data_ptr(), B, N, C, num_cells, out.data_ptr(),
        counts.data_ptr()),
        feat, launches, "scatter_mean")
    return out, counts


def pooled_max_cuda(feat: torch.Tensor, index: torch.Tensor,
                    num_cells: int, csr: CSR | None = None
                    ) -> tuple[torch.Tensor, tuple]:
    """Each point of `feat` [B, N, C] f32 given the max, channel by
    channel, over the points of its cell of `index` [B, N] (integers in
    [0, num_cells), checked on the card as in `scatter_mean_cuda`), read
    from `csr` (built here when not given). -> (out [B, N, C], the state
    `pooled_max_backward_cuda` takes: the CSR and each cell's tie
    count)."""
    _check("pooled_max_cuda", feat, index, num_cells, csr)
    csr = build_csr(index, num_cells) if csr is None else csr
    B, N, C = feat.shape
    out = torch.empty_like(feat, memory_format=torch.contiguous_format)
    ties = torch.empty_like(out)
    if out.numel():
        feat = feat.contiguous()
        fn = _build.bind("scatter", "ifdef_pooled_max",
                         [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P])
        _build.launch("scatter", "pooled_max", fn, (
            feat.data_ptr(), csr.index.data_ptr(),
            int(csr.index.dtype == torch.int64), csr.offsets.data_ptr(),
            csr.rows.data_ptr(), B, N, C, num_cells, out.data_ptr(),
            ties.data_ptr()),
            feat, launches, "pooled_max")
    return out, (csr, ties)


def pooled_max_backward_cuda(grad_out: torch.Tensor, feat: torch.Tensor,
                             out: torch.Tensor, state: tuple) -> torch.Tensor:
    """The gradient to `feat` of `pooled_max_cuda(feat, ...)` = `out`, fed
    `grad_out` [B, N, C]: each cell's output gradients added in point order
    and shared evenly among the points equal to its max. `state` is what
    the forward returned beside `out`."""
    csr, ties = state
    _check("pooled_max_backward_cuda", grad_out, csr.index,
           csr.num_targets, csr)
    if grad_out.shape != feat.shape:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} is not the "
                         f"features' {tuple(feat.shape)}")
    B, N, C = feat.shape
    grad = torch.empty_like(out)
    if grad.numel():
        grad_out, feat = grad_out.contiguous(), feat.contiguous()
        fn = _build.bind("scatter", "ifdef_pooled_max_backward",
                         [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                          _P, _P])
        _build.launch("scatter", "pooled_max_backward", fn, (
            grad_out.data_ptr(), feat.data_ptr(), out.data_ptr(),
            ties.data_ptr(), csr.index.data_ptr(),
            int(csr.index.dtype == torch.int64), csr.offsets.data_ptr(),
            csr.rows.data_ptr(), B, N, C, csr.num_targets, grad.data_ptr()),
            grad_out, launches, "pooled_max_backward")
    return grad
