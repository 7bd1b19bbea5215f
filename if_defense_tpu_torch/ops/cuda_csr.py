"""Wrapper of the CUDA kernel that groups each cloud's rows by target
(`csrc/csr.cu`): a CSR built on the card by a counting sort.

Replaces no TPU kernel. It feeds the port's kernels that take each
target's rows in row order, the gather's backward (`ops/cuda_gather.py`)
and the encoder's scatter-mean and pooled max (`ops/cuda_scatter.py`),
in the place of torch's radix sort, casts and fills. `csr_plain` is its
plain version: a stable argsort and a cumulative count, for the CPU and
the tests.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from if_defense_tpu_torch.ops import _build

# kernel launches, counted where they happen
launches = {"csr": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int

# targets a cloud above which the kernel's table lives in device memory
SHARED_TARGETS = 32768


class CSR(NamedTuple):
    """Each cloud's rows grouped by target: target k of cloud b reads rows
    `rows[b, offsets[b, k]:offsets[b, k + 1]]`, in increasing order.
    `index` is the [B, M] integer index it was built from (kept for the
    kernels that look a row's target up), `num_targets` its range."""

    offsets: torch.Tensor          # [B, K + 1] int32, from 0 to M
    rows: torch.Tensor             # [B, M] int32
    index: torch.Tensor            # [B, M] int32 or int64, contiguous
    num_targets: int


def _check(index: torch.Tensor, num_targets: int) -> None:
    if index.dim() != 2:
        raise ValueError(f"index must be [B, M], not {tuple(index.shape)}")
    if index.dtype.is_floating_point or index.dtype.is_complex \
            or index.dtype == torch.bool:
        raise TypeError(f"index must be integer, not {index.dtype}")
    B, M = index.shape
    if num_targets < 1 or num_targets > 2**31 - 2 or M > 2**31 - 1025:
        raise ValueError(f"{num_targets} targets for {M} rows out of range")


def build_csr(index: torch.Tensor, num_targets: int) -> CSR:
    """The CSR of `index` [B, M] (integers on a CUDA device, each in
    [0, num_targets); int32 and int64 read as they are, any other integer
    type cast to int64 first), one launch. Its range is checked on the
    card, with no host sync: an index outside it stops the kernel, and the
    CUDA error it leaves (as `gather`'s device assert does) raises at the
    next sync."""
    _check(index, num_targets)
    if not index.is_cuda:
        raise ValueError("build_csr takes CUDA tensors")
    B, M = index.shape
    if index.dtype not in (torch.int32, torch.int64):
        index = index.long()
    index = index.contiguous()
    offsets = torch.empty((B, num_targets + 1), dtype=torch.int32,
                          device=index.device)
    rows = torch.empty((B, M), dtype=torch.int32, device=index.device)
    scratch = (torch.empty((B, num_targets), dtype=torch.int32,
                           device=index.device)
               if num_targets > SHARED_TARGETS and B else None)
    if B:
        fn = _build.bind("csr", "ifdef_csr_build",
                         [_P, _I, _I, _I, _I, _P, _P, _P, _P])
        _build.launch("csr", "csr_build", fn, (
            index.data_ptr(), int(index.dtype == torch.int64), B, M,
            num_targets, offsets.data_ptr(), rows.data_ptr(),
            None if scratch is None else scratch.data_ptr()),
            index, launches, "csr")
    return CSR(offsets, rows, index, num_targets)


def csr_plain(index: torch.Tensor, num_targets: int) -> CSR:
    """The plain version of `build_csr`, on any device: a stable argsort
    of each cloud's indices and a cumulative count of each target's rows
    (an index outside [0, num_targets) raises)."""
    _check(index, num_targets)
    B, M = index.shape
    idx = index.long()
    if M and (int(idx.min()) < 0 or int(idx.max()) >= num_targets):
        raise IndexError(f"index outside [0, {num_targets})")
    rows = torch.sort(idx, dim=1, stable=True)[1].to(torch.int32)
    counts = torch.zeros((B, num_targets), dtype=torch.int64,
                         device=index.device).scatter_add_(
        1, idx, torch.ones_like(idx))
    offsets = torch.zeros((B, num_targets + 1), dtype=torch.int64,
                          device=index.device)
    offsets[:, 1:] = counts.cumsum(1)
    return CSR(offsets.to(torch.int32), rows.contiguous(),
               index.contiguous(), num_targets)
