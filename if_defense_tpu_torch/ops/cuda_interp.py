"""Wrappers of the CUDA plane-feature kernel (B4, `csrc/interp.cu`).

Replaces `fused_bilinear_plane_sample` of
`if_defense_tpu/ops/pallas_interp.py:233` in two forms:
- the p form (`plane_features_cuda`), as the ConvONet decoder uses it: the
  features of 1-3 channel-last planes at the points p, each plane's
  projection and normalisation (`normalize_coordinate`) and the sum over
  the planes included, in one launch forward and one per gradient asked
  for; its plain PyTorch version is `ops.interp.plane_features`;
- the uv form (`plane_sample_cuda`), the Pallas kernel's own: one plane at
  coordinates uv already normalised; its plain version is
  `ops.interp.bilinear_plane_sample`.
Both take tensors on a CUDA device only, and any channel count (16-byte
moves where the channels fill whole 16-byte words, one channel at a time
otherwise); `LocalDecoder.sample_features` and `ops.interp.plane_sample`
choose between kernel and plain version by the tensor's device.

The backward launches only what autograd asks for: the gradient to p (the
defense, planes frozen) and the planes' gradients (implicit-network
training, queries are data). Both are deterministic: two launches on one
input give the same bits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from if_defense_tpu_torch.ops import _build
from if_defense_tpu_torch.ops.interp import PLANE_AXES

MAX_PLANES = 3

# kernel launches, counted where they happen
launches = {"plane_features": 0, "plane_features_dp": 0,
            "plane_features_dplane": 0, "plane_sample": 0,
            "plane_sample_duv": 0, "plane_sample_dplane": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PP, _PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_HEAD = [_P, _I, _PP, _PI, _I, _I, _I, _I, _I, _I, _F, _F]
_UV_HEAD = [_P, _I, _P, _I, _I, _I, _I, _I]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _head(p, planes, axes, inv_scale, hi) -> list:
    """The arguments the three C entry points share."""
    B, Q, _ = p.shape
    _, H, W, C = planes[0].shape
    ptrs = (ctypes.c_void_p * MAX_PLANES)(*[t.data_ptr() for t in planes])
    ax = (ctypes.c_int * (2 * MAX_PLANES))(*axes)
    return [p.data_ptr(), int(p.dtype == torch.bfloat16), ptrs, ax,
            len(planes), B, Q, H, W, C, inv_scale, hi]


class _PlaneFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, axes, inv_scale, hi, *planes):
        B, Q, _ = p.shape
        C = planes[0].shape[-1]
        out = torch.empty((B, Q, C), dtype=planes[0].dtype, device=p.device)
        fn = _build.bind("interp", "ifdef_plane_features_fwd",
                         _HEAD + [_P, _P])
        err = fn(*_head(p, planes, axes, inv_scale, hi), out.data_ptr(),
                 _stream(p))
        launches["plane_features"] += 1
        _build.check("interp", err, "plane_features forward")
        ctx.save_for_backward(p, *planes)
        ctx.params = (axes, inv_scale, hi)
        return out

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            # create_graph: the kernels' gradients carry no graph of their
            # own, so a second derivative would silently lose their terms
            raise RuntimeError("plane_features_cuda (kernel B4) has no "
                               "second derivative; use the plain "
                               "ops.plane_features for create_graph")
        p, *planes = ctx.saved_tensors
        axes, inv_scale, hi = ctx.params
        need_p, need_planes = ctx.needs_input_grad[0], ctx.needs_input_grad[4:]
        g = g.to(planes[0].dtype).contiguous()
        head = _head(p, planes, axes, inv_scale, hi)
        dp = None
        dplanes = [None] * len(planes)
        if need_p:
            dp = torch.empty_like(p)
            fn = _build.bind("interp", "ifdef_plane_features_dp",
                             _HEAD + [_P, _P, _P])
            err = fn(*head, g.data_ptr(), dp.data_ptr(), _stream(p))
            launches["plane_features_dp"] += 1
            _build.check("interp", err, "plane_features gradient to p")
        if any(need_planes):
            # every cell of a plane asked for is written: no fill
            dplanes = [torch.empty_like(pl) if need else None
                       for pl, need in zip(planes, need_planes)]
            ptrs = (ctypes.c_void_p * MAX_PLANES)(
                *[0 if d is None else d.data_ptr() for d in dplanes])
            fn = _build.bind("interp", "ifdef_plane_features_dplane",
                             _HEAD + [_P, _PP, _P])
            err = fn(*head, g.data_ptr(), ptrs, _stream(p))
            launches["plane_features_dplane"] += 1
            _build.check("interp", err, "plane_features plane gradients")
        return (dp, None, None, None, *dplanes)


def _check(p: torch.Tensor, planes: list) -> None:
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes, not {len(planes)}")
    if not (p.is_cuda and all(t.device == p.device for t in planes)):
        raise ValueError("plane_features_cuda takes CUDA tensors on one device")
    dtype = p.dtype
    if dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dtype for t in planes):
        raise TypeError("p and the planes must all be float32 or all "
                        f"bfloat16, not {dtype} / {[t.dtype for t in planes]}")
    shape = planes[0].shape
    if p.dim() != 3 or p.shape[-1] != 3 or len(shape) != 4 \
            or shape[0] != p.shape[0] or any(t.shape != shape for t in planes):
        raise ValueError(
            f"shapes {tuple(p.shape)} / {[tuple(t.shape) for t in planes]} "
            "are not [B, Q, 3] / planes of one [B, H, W, C] shape")
    if not (p.is_contiguous() and all(t.is_contiguous() for t in planes)):
        raise ValueError("p and the planes must be contiguous")


def plane_features_cuda(p: torch.Tensor, planes: dict[str, torch.Tensor],
                        padding: float = 0.1) -> torch.Tensor:
    """Sum over the planes, in the dict's order, of the bilinear samples of
    `[B, H, W, C]` planes (keys from `PLANE_AXES`) at the points `p`
    `[B, Q, 3]` projected and normalised as `normalize_coordinate` does ->
    `[B, Q, C]`; p and the planes all f32 or all bf16, math in f32.

    Gradients flow to p (zero where the normalisation's clamp holds a
    coordinate) and to the planes (summed in f32).
    """
    names = list(planes)
    if any(n not in PLANE_AXES for n in names):
        raise ValueError(f"planes {names} are not among {list(PLANE_AXES)}")
    tensors = [planes[n] for n in names]
    _check(p, tensors)
    axes = [a for n in names for a in PLANE_AXES[n]]
    axes += [0] * (2 * MAX_PLANES - len(axes))
    # torch's CUDA division by a Python scalar multiplies by the scalar's
    # reciprocal, taken in double and rounded to f32 once
    inv_scale = float(np.float32(1.0 / (1 + padding + 1e-5)))
    hi = float(np.float32(1.0 - 1e-5))
    return _PlaneFeatures.apply(p, axes, inv_scale, hi, *tensors)


def _uv_head(uv: torch.Tensor, plane: torch.Tensor) -> list:
    B, Q, _ = uv.shape
    _, H, W, C = plane.shape
    return [uv.data_ptr(), int(uv.dtype == torch.bfloat16), plane.data_ptr(),
            B, Q, H, W, C]


class _PlaneSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uv, plane):
        B, Q, _ = uv.shape
        out = torch.empty((B, Q, plane.shape[-1]), dtype=plane.dtype,
                          device=uv.device)
        fn = _build.bind("interp", "ifdef_plane_sample_fwd",
                         _UV_HEAD + [_P, _P])
        err = fn(*_uv_head(uv, plane), out.data_ptr(), _stream(uv))
        launches["plane_sample"] += 1
        _build.check("interp", err, "plane_sample forward")
        ctx.save_for_backward(uv, plane)
        return out

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError("plane_sample_cuda (kernel B4) has no second "
                               "derivative; use the plain "
                               "ops.bilinear_plane_sample for create_graph")
        uv, plane = ctx.saved_tensors
        g = g.to(plane.dtype).contiguous()
        head = _uv_head(uv, plane)
        duv = dplane = None
        if ctx.needs_input_grad[0]:
            duv = torch.empty_like(uv)
            fn = _build.bind("interp", "ifdef_plane_sample_duv",
                             _UV_HEAD + [_P, _P, _P])
            err = fn(*head, g.data_ptr(), duv.data_ptr(), _stream(uv))
            launches["plane_sample_duv"] += 1
            _build.check("interp", err, "plane_sample gradient to uv")
        if ctx.needs_input_grad[1]:
            dplane = torch.empty_like(plane)      # every cell is written
            fn = _build.bind("interp", "ifdef_plane_sample_dplane",
                             _UV_HEAD + [_P, _P, _P])
            err = fn(*head, g.data_ptr(), dplane.data_ptr(), _stream(uv))
            launches["plane_sample_dplane"] += 1
            _build.check("interp", err, "plane_sample plane gradient")
        return duv, dplane


def plane_sample_cuda(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the channel-last planes `[B, H, W, C]` at `uv`
    `[B, Q, 2]` (x -> W, y -> H, each clamped to [0, 1], align_corners,
    border clamp) -> `[B, Q, C]`; plane and uv both f32 or both bf16, math
    in f32. Gradients flow to uv (zero where the clamp holds a coordinate)
    and to the plane (summed in f32)."""
    if not (uv.is_cuda and plane.device == uv.device):
        raise ValueError("plane_sample_cuda takes CUDA tensors on one device")
    if uv.dtype not in (torch.float32, torch.bfloat16) \
            or plane.dtype != uv.dtype:
        raise TypeError("uv and the plane must both be float32 or both "
                        f"bfloat16, not {uv.dtype} / {plane.dtype}")
    if uv.dim() != 3 or uv.shape[-1] != 2 or plane.dim() != 4 \
            or plane.shape[0] != uv.shape[0]:
        raise ValueError(f"shapes {tuple(uv.shape)} / {tuple(plane.shape)} "
                         "are not [B, Q, 2] / [B, H, W, C]")
    if not (uv.is_contiguous() and plane.is_contiguous()):
        raise ValueError("uv and the plane must be contiguous")
    return _PlaneSample.apply(uv, plane)
