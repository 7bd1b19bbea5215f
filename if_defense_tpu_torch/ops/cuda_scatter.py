"""Wrapper of the CUDA scatter-mean kernel (`csrc/scatter.cu`).

Replaces no TPU kernel: the JAX package's `ops/scatter.py:20-38` writes the
encoder's scatter-mean as a one-hot matmul, and the port's plain version,
`ops.scatter.scatter_mean_2d_plain`, sums with `scatter_add_`, whose
atomics on the card add in an order that changes from run to run. The
kernel adds each cell's points in point order, the order the plain version
adds them in on the CPU, so it gives that version's bits on a CPU copy and
the same bits launch after launch. Takes f32 tensors on a CUDA device
only; `ops.scatter.scatter_mean_2d` chooses between kernel and plain
version by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from if_defense_tpu_torch.ops import _build

# kernel launches, counted where they happen
launches = {"scatter_mean": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def scatter_mean_cuda(feat: torch.Tensor, index: torch.Tensor,
                      num_cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cloud mean of `feat` [B, N, C] f32 over the points of each cell
    of `index` [B, N] (integers in [0, num_cells)). -> (means
    [B, num_cells, C], 0 in empty cells; each point's cell count [B, N]
    f32). The range of `index` is checked on the card, with no host sync:
    an index outside it stops the kernel, and the CUDA error it leaves
    (as `scatter_add_`'s device assert does) raises at the next sync."""
    if not feat.is_cuda:
        raise ValueError("scatter_mean_cuda takes CUDA tensors")
    if feat.dtype != torch.float32:
        raise TypeError(f"features must be float32, not {feat.dtype}")
    if feat.dim() != 3:
        raise ValueError(f"features must be [B, N, C], not "
                         f"{tuple(feat.shape)}")
    B, N, C = feat.shape
    if tuple(index.shape) != (B, N) or index.device != feat.device:
        raise ValueError(f"index must be [{B}, {N}] on the features' device")
    if index.dtype.is_floating_point or index.dtype == torch.bool:
        raise TypeError(f"index must be integer, not {index.dtype}")
    if num_cells < 1 or num_cells > 2**31 - 1:
        raise ValueError(f"num_cells={num_cells} out of range")
    out = torch.zeros((B, num_cells, C), dtype=feat.dtype, device=feat.device)
    counts = torch.empty((B, N), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0 or N == 0:
        return out, counts
    # a stable sort keeps each cell's points in point order
    sorted_idx, perm = torch.sort(index.to(torch.int32), dim=1, stable=True)
    sorted_idx = sorted_idx.contiguous()
    perm = perm.to(torch.int32).contiguous()
    feat = feat.contiguous()
    fn = _build.bind("scatter", "ifdef_scatter_mean",
                     [_P, _P, _P, _I, _I, _I, _I, _P, _P])
    _build.launch("scatter", "scatter_mean", fn, (
        feat.data_ptr(), sorted_idx.data_ptr(), perm.data_ptr(), B, N, C,
        num_cells, out.data_ptr(), counts.data_ptr()),
        feat, launches, "scatter_mean")
    return out, counts
