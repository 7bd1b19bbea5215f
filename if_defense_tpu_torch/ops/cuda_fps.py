"""Wrapper of the CUDA farthest-point-sampling kernel (B5, `csrc/fps.cu`).

Replaces `fps_pallas` of `if_defense_tpu/ops/pallas_fps.py:82`, and the
masked lax path of `if_defense_tpu/ops/pointops.py:252-273`. Takes tensors
on a CUDA device only; the plain PyTorch version is
`ops.pointops.farthest_point_sample_plain`, and
`ops.pointops.farthest_point_sample` chooses between the two by the
tensor's device. Any N: above the kernel's register tier the running
minima live in a `[B, N]` f32 scratch buffer that the wrapper allocates.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from if_defense_tpu_torch.ops import _build

# kernel launches, counted where they happen
launches = {"fps": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _register_n() -> int:
    """The largest N whose running minima the kernel keeps in registers."""
    return _build.bind("fps", "ifdef_fps_register_n", [])()


def fps_cuda(xyz: torch.Tensor, npoint: int,
             start_idx: torch.Tensor | None = None,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """B5: farthest point sampling, `[B, N, 3]` f32 -> `[B, npoint]` int32.

    Starts at `start_idx` ([B]), else at the first valid point under `mask`
    ([B, N], > 0 is valid), else at 0; first maximum on ties.
    """
    if not xyz.is_cuda:
        raise ValueError("fps_cuda takes CUDA tensors")
    if xyz.dtype != torch.float32:
        raise TypeError(f"points must be float32, not {xyz.dtype}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or 0 in xyz.shape[:2]:
        raise ValueError(f"points must be a non-empty [B, N, 3], not "
                         f"{tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("points must be contiguous")
    B, N, _ = xyz.shape
    if npoint < 1:
        raise ValueError(f"npoint={npoint} must be positive")
    valid = start = None
    if mask is not None:
        if tuple(mask.shape) != (B, N) or mask.device != xyz.device:
            raise ValueError(f"mask must be [{B}, {N}] on the points' device")
        valid = (mask > 0).contiguous()
    if start_idx is not None:
        if tuple(start_idx.shape) != (B,) or start_idx.device != xyz.device:
            raise ValueError(f"start_idx must be [{B}] on the points' device")
        start = start_idx.to(torch.int32).contiguous()
        if not bool(((start >= 0) & (start < N)).all()):
            raise ValueError(f"start_idx must lie in [0, {N})")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    dist = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
            if N > _register_n() else None)
    fn = _build.bind("fps", "ifdef_fps", [_P, _P, _P, _I, _I, _I, _P, _P, _P])
    err = fn(xyz.data_ptr(), None if valid is None else valid.data_ptr(),
             None if start is None else start.data_ptr(), B, N, npoint,
             out.data_ptr(), None if dist is None else dist.data_ptr(),
             torch.cuda.current_stream(xyz.device).cuda_stream)
    launches["fps"] += 1
    _build.check("fps", err, "fps")
    return out
