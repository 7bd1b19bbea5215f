"""Wrapper of the CUDA ball-query kernel (B6, `csrc/ballquery.cu`).

Replaces `ballquery_pallas` of `if_defense_tpu/ops/pallas_ballquery.py:71`,
and the masked XLA path of `if_defense_tpu/ops/pointops.py:323-343`. Takes
tensors on a CUDA device only; the plain PyTorch version is
`ops.pointops.query_ball_point_plain`, and `ops.pointops.query_ball_point`
chooses between the two by the tensor's device. Any B, N, S and nsample:
the kernel scans one centre a thread over the cloud staged in shared
memory, 4096 points at a time, with 1, 2, 4 or 8 warps on each group of 32
centres (more where the centres are few).
"""

from __future__ import annotations

import ctypes

import torch

from if_defense_tpu_torch.ops import _build

# kernel launches, counted where they happen
launches = {"ballquery": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def ballquery_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                   new_xyz: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """B6: the first `nsample` points within `radius` of each centre, in
    index order, `[B, N, 3]`, `[B, S, 3]` f32 -> `[B, S, nsample]` int32;
    empty slots repeat the first hit, a centre with none gets 0. Points with
    `mask` ([B, N]) <= 0 are never grouped."""
    if not (xyz.is_cuda and new_xyz.is_cuda and xyz.device == new_xyz.device):
        raise ValueError("ballquery_cuda takes CUDA tensors on one device")
    if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32:
        raise TypeError(f"points must be float32, not {xyz.dtype} / "
                        f"{new_xyz.dtype}")
    if (xyz.dim() != 3 or new_xyz.dim() != 3 or xyz.shape[-1] != 3
            or new_xyz.shape[-1] != 3 or xyz.shape[0] != new_xyz.shape[0]
            or 0 in (*xyz.shape[:2], new_xyz.shape[1])):
        raise ValueError(f"shapes {tuple(xyz.shape)} / {tuple(new_xyz.shape)} "
                         "are not a non-empty [B, N, 3] / [B, S, 3]")
    if not (xyz.is_contiguous() and new_xyz.is_contiguous()):
        raise ValueError("points and centres must be contiguous")
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if nsample < 1:
        raise ValueError(f"nsample={nsample} must be >= 1")
    valid = None
    if mask is not None:
        if tuple(mask.shape) != (B, N) or mask.device != xyz.device:
            raise ValueError(f"mask must be [{B}, {N}] on the points' device")
        valid = (mask > 0).contiguous()
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    fn = _build.bind("ballquery", "ifdef_ballquery",
                     [_P, _P, _P, _I, _I, _I, _I, _F, _P, _P])
    # r2 rounds to f32 as the plain version's comparison with radius ** 2 does
    err = fn(xyz.data_ptr(), new_xyz.data_ptr(),
             None if valid is None else valid.data_ptr(), B, N, S, nsample,
             float(radius) ** 2, out.data_ptr(),
             torch.cuda.current_stream(xyz.device).cuda_stream)
    launches["ballquery"] += 1
    _build.check("ballquery", err, "ballquery")
    return out
