"""Wrapper of the CUDA bilinear plane-sampling kernel (B4, `csrc/interp.cu`).

Replaces `fused_bilinear_plane_sample` of
`if_defense_tpu/ops/pallas_interp.py:233`. Takes tensors on a CUDA device
only; the plain PyTorch version is `ops.interp.bilinear_plane_sample`, and
`ops.interp.plane_sample` chooses between the two by the tensor's device.

The backward launches only what autograd asks for: the uv gradient (the
defense, planes frozen) and the plane gradient (implicit-network training,
queries are data). The plane gradient adds with f32 atomics, so its last
bits vary from run to run (`csrc/interp.cu`).
"""

from __future__ import annotations

import ctypes

import torch

from if_defense_tpu_torch.ops import _build

# kernel launches, counted where they happen: the forward and the uv
# gradient under "plane_sample", the plane gradient under its own name
launches = {"plane_sample": 0, "plane_sample_dplane": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class _PlaneSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plane, uv):
        B, H, W, C = plane.shape
        Q = uv.shape[1]
        out = torch.empty((B, Q, C), dtype=plane.dtype, device=plane.device)
        fn = _build.bind("interp", "ifdef_plane_sample_fwd",
                         [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P])
        err = fn(plane.data_ptr(), int(plane.dtype == torch.bfloat16),
                 uv.data_ptr(), B, H, W, C, Q, out.data_ptr(), _stream(plane))
        launches["plane_sample"] += 1
        _build.check("interp", err, "plane_sample forward")
        ctx.save_for_backward(plane, uv)
        return out

    @staticmethod
    def backward(ctx, g):
        plane, uv = ctx.saved_tensors
        need_plane, need_uv = ctx.needs_input_grad
        B, H, W, C = plane.shape
        Q = uv.shape[1]
        is_bf16 = int(plane.dtype == torch.bfloat16)
        g = g.to(plane.dtype).contiguous()
        dplane = duv = None
        if need_uv:
            duv = torch.empty_like(uv)
            fn = _build.bind("interp", "ifdef_plane_sample_bwd",
                             [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P])
            err = fn(plane.data_ptr(), is_bf16, uv.data_ptr(), g.data_ptr(),
                     B, H, W, C, Q, duv.data_ptr(), _stream(plane))
            launches["plane_sample"] += 1
            _build.check("interp", err, "plane_sample uv gradient")
        if need_plane:
            # the kernel adds into a zero-filled f32 buffer; bf16 is cast once
            acc = torch.zeros((B, H, W, C), dtype=torch.float32,
                              device=plane.device)
            fn = _build.bind("interp", "ifdef_plane_sample_bwd_plane",
                             [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P])
            err = fn(uv.data_ptr(), g.data_ptr(), is_bf16, B, H, W, C, Q,
                     acc.data_ptr(), _stream(plane))
            launches["plane_sample_dplane"] += 1
            _build.check("interp", err, "plane_sample plane gradient")
            dplane = acc.to(plane.dtype)
        return dplane, duv


def plane_sample_cuda(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of `[B, H, W, C]` planes (f32 or bf16) at
    `[B, Q, 2]` uv in [0, 1] (x -> W, y -> H, align_corners=True, border
    clamp) -> `[B, Q, C]` in the plane's type; math in f32.

    Gradients flow to uv (zero where the clamp holds it) and to the plane
    (in the plane's type, summed in f32 by atomics, so not bit-for-bit
    repeatable).
    """
    if not (plane.is_cuda and uv.is_cuda and plane.device == uv.device):
        raise ValueError("plane_sample_cuda takes CUDA tensors on one device")
    if plane.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"plane must be float32 or bfloat16, not {plane.dtype}")
    if not uv.dtype.is_floating_point:
        raise TypeError(f"uv must be floating point, not {uv.dtype}")
    if plane.dim() != 4 or uv.dim() != 3 or uv.shape[-1] != 2 \
            or uv.shape[0] != plane.shape[0]:
        raise ValueError(f"shapes {tuple(plane.shape)} / {tuple(uv.shape)} "
                         "are not [B, H, W, C] / [B, Q, 2]")
    if not (plane.is_contiguous() and uv.is_contiguous()):
        raise ValueError("plane and uv must be contiguous")
    return _PlaneSample.apply(plane, uv.float())
