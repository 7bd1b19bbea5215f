"""Wrapper of the CUDA kernel of the gather's backward in a fixed order
(`csrc/gather.cu`).

Replaces no TPU kernel: the JAX package's `ops/pointops.py:49-58`
`index_points` is `p[i]`, whose VJP is an XLA scatter-add, and its
`gather_neighbors` a one-hot contraction with a custom VJP. The port's
plain version, `ops.pointops.index_points_plain`, is `torch.gather`, whose
backward on the card adds with atomics in an order that changes from run to
run (and under deterministic algorithms sorts and runs torch's index
backward). The kernel adds each point's rows in row order, the order of
the plain version's autograd on the CPU, so it gives those bits on a CPU
copy and the same bits launch after launch. A call is two launches: each
cloud's CSR (`ops/cuda_csr.py`), then the sums. It takes f32 tensors on a
CUDA device only; `ops.pointops.index_points` runs it in its backward on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from if_defense_tpu_torch.ops import _build
from if_defense_tpu_torch.ops.cuda_csr import build_csr

# kernel launches, counted where they happen
launches = {"gather_backward": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def gather_backward_cuda(grad_out: torch.Tensor, idx: torch.Tensor,
                         num_points: int) -> torch.Tensor:
    """The gradient to `points` [B, num_points, C] of the gather
    `out[b, m] = points[b, idx[b, m]]`, fed `grad_out` [B, M, C] f32:
    each point's rows added in increasing m from 0, 0 for a point no row
    reads. `idx` [B, M] is int32 or int64 beside `grad_out`; its range is
    checked on the card, with no host sync: an index outside
    [0, num_points) stops the kernel, and the CUDA error it leaves (as
    `gather`'s device assert does) raises at the next sync."""
    if grad_out.dtype != torch.float32:
        raise TypeError(f"grad_out must be float32, not {grad_out.dtype}")
    if grad_out.dim() != 3:
        raise ValueError(f"grad_out must be [B, M, C], not "
                         f"{tuple(grad_out.shape)}")
    B, M, C = grad_out.shape
    if tuple(idx.shape) != (B, M) or idx.device != grad_out.device:
        raise ValueError(f"idx must be [{B}, {M}] on grad_out's device")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, not {idx.dtype}")
    if num_points < 1 or num_points > 2**31 - 2 or M > 2**31 - 1025:
        raise ValueError(f"num_points={num_points} out of range for "
                         f"{B} x {M} rows")
    if not grad_out.is_cuda:
        raise ValueError("gather_backward_cuda takes CUDA tensors")
    grad = torch.empty((B, num_points, C), dtype=grad_out.dtype,
                       device=grad_out.device)
    if grad.numel() == 0:
        return grad
    csr = build_csr(idx, num_points)
    grad_out = grad_out.contiguous()
    fn = _build.bind("gather", "ifdef_gather_backward",
                     [_P, _P, _P, _I, _I, _I, _I, _P, _P])
    _build.launch("gather", "gather_backward", fn, (
        grad_out.data_ptr(), csr.offsets.data_ptr(), csr.rows.data_ptr(),
        B, M, num_points, C, grad.data_ptr()),
        grad_out, launches, "gather_backward")
    return grad
