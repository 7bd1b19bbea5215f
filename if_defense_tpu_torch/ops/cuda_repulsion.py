"""Wrappers of the CUDA repulsion kernels (B1, B2, B3; `csrc/repulsion.cu`).

Replace `fused_repulsion_loss`, `fused_repulsion_mask` and
`fused_repulsion_loss_masked` of `if_defense_tpu/ops/pallas_repulsion.py`
(:196, :267, :390). They take tensors on a CUDA device only; the plain
PyTorch versions (`repulsion_loss_threshold`, `repulsion_mask`,
`repulsion_loss_masked` in `defense/repulsion.py`) hold the same semantics,
and the `*_auto` dispatchers there choose by the tensor's device.

Points are f32 or bf16 (math in f32), losses f32 `[B]`, gradients in the
points' type. The forward of B1 keeps each row's threshold and tie weight
for its backward, so the backward does no selection. Any N: the kernels
walk the partners in chunks staged in shared memory; only the `[B, N, N]`
int8 mask of B2/B3 grows with N^2, and `torch.empty` reports where it does
not fit. Any k in [1, N): up to 8 the kernels keep a sorted top-k in
registers, above they scan for each row's k-th smallest distance.
"""

from __future__ import annotations

import ctypes

import torch

from if_defense_tpu_torch.ops import _build

# kernel launches, counted where they happen (forward and backward)
launches = {"repulsion_loss": 0, "repulsion_mask": 0,
            "repulsion_loss_masked": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_points(pc: torch.Tensor, k: int) -> None:
    if not pc.is_cuda:
        raise ValueError("the CUDA repulsion kernels take CUDA tensors")
    if pc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"points must be float32 or bfloat16, not {pc.dtype}")
    if pc.dim() != 3 or pc.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], not {tuple(pc.shape)}")
    if not pc.is_contiguous():
        raise ValueError("points must be contiguous")
    n = pc.shape[1]
    if not 1 <= k < n:
        raise ValueError(f"k={k} must be at least 1 and below N={n}")


def _check_mask(pc: torch.Tensor, mask: torch.Tensor) -> None:
    B, N, _ = pc.shape
    if mask.dtype != torch.int8 or tuple(mask.shape) != (B, N, N):
        raise ValueError(f"mask must be int8 [{B}, {N}, {N}], not "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if mask.device != pc.device or not mask.is_contiguous():
        raise ValueError("mask must be contiguous on the points' device")


def _is_bf16(pc: torch.Tensor) -> int:
    return int(pc.dtype == torch.bfloat16)


class _RepulsionLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pc, k, radius, h, eps):
        B, N, _ = pc.shape
        loss = torch.empty(B, dtype=torch.float32, device=pc.device)
        thr, frac, rows = torch.empty(
            (3, B, N), dtype=torch.float32, device=pc.device).unbind(0)
        fn = _build.bind("repulsion", "ifdef_repulsion_fwd",
                         [_P, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P])
        err = fn(pc.data_ptr(), _is_bf16(pc), B, N, k, radius, h, eps,
                 loss.data_ptr(), thr.data_ptr(), frac.data_ptr(),
                 rows.data_ptr(), _stream(pc))
        launches["repulsion_loss"] += 1
        _build.check("repulsion", err, "repulsion_loss forward")
        ctx.save_for_backward(pc, thr, frac)
        ctx.params = (k, radius, h, eps)
        return loss

    @staticmethod
    def backward(ctx, g):
        pc, thr, frac = ctx.saved_tensors
        k, radius, h, eps = ctx.params
        B, N, _ = pc.shape
        g = g.float().contiguous()
        grad = torch.empty_like(pc)
        fn = _build.bind("repulsion", "ifdef_repulsion_bwd",
                         [_P, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P])
        err = fn(pc.data_ptr(), _is_bf16(pc), B, N, k, radius, h, eps,
                 thr.data_ptr(), frac.data_ptr(), g.data_ptr(),
                 grad.data_ptr(), _stream(pc))
        launches["repulsion_loss"] += 1
        _build.check("repulsion", err, "repulsion_loss backward")
        return grad, None, None, None, None


class _RepulsionLossMasked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pc, mask, k, radius, h, eps):
        B, N, _ = pc.shape
        loss = torch.empty(B, dtype=torch.float32, device=pc.device)
        rows = torch.empty((B, N), dtype=torch.float32, device=pc.device)
        fn = _build.bind("repulsion", "ifdef_repulsion_masked_fwd",
                         [_P, _I, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P])
        err = fn(pc.data_ptr(), _is_bf16(pc), mask.data_ptr(), B, N, k,
                 radius, h, eps, loss.data_ptr(), rows.data_ptr(),
                 _stream(pc))
        launches["repulsion_loss_masked"] += 1
        _build.check("repulsion", err, "repulsion_loss_masked forward")
        ctx.save_for_backward(pc, mask)
        ctx.params = (k, radius, h, eps)
        return loss

    @staticmethod
    def backward(ctx, g):
        pc, mask = ctx.saved_tensors
        k, radius, h, eps = ctx.params
        B, N, _ = pc.shape
        g = g.float().contiguous()
        grad = torch.empty_like(pc)
        fn = _build.bind("repulsion", "ifdef_repulsion_masked_bwd",
                         [_P, _I, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P])
        err = fn(pc.data_ptr(), _is_bf16(pc), mask.data_ptr(), B, N, k,
                 radius, h, eps, g.data_ptr(), grad.data_ptr(), _stream(pc))
        launches["repulsion_loss_masked"] += 1
        _build.check("repulsion", err, "repulsion_loss_masked backward")
        return grad, None, None, None, None, None


def repulsion_loss_cuda(pc: torch.Tensor, nn_size: int = 5,
                        radius: float = 0.07, h: float = 0.03,
                        eps: float = 1e-12) -> torch.Tensor:
    """B1: per-cloud repulsion loss with exact k-NN selection (fractional
    weights at ties), `[B, N, 3]` -> `[B]`, differentiable in the points."""
    _check_points(pc, nn_size)
    return _RepulsionLoss.apply(pc, nn_size, radius, h, eps)


def repulsion_mask_cuda(pc: torch.Tensor, nn_size: int = 5) -> torch.Tensor:
    """B2: int8 `[B, N, N]` neighbour mask, 1 where d2 <= the row's k-th
    smallest (every tie included), diagonal 0."""
    _check_points(pc, nn_size)
    B, N, _ = pc.shape
    mask = torch.empty((B, N, N), dtype=torch.int8, device=pc.device)
    fn = _build.bind("repulsion", "ifdef_repulsion_mask",
                     [_P, _I, _I, _I, _I, _P, _P])
    err = fn(pc.data_ptr(), _is_bf16(pc), B, N, nn_size, mask.data_ptr(),
             _stream(pc))
    launches["repulsion_mask"] += 1
    _build.check("repulsion", err, "repulsion_mask")
    return mask


def repulsion_loss_masked_cuda(pc: torch.Tensor, mask: torch.Tensor,
                               nn_size: int = 5, radius: float = 0.07,
                               h: float = 0.03,
                               eps: float = 1e-12) -> torch.Tensor:
    """B3: B1's loss with the weights taken from a cached int8 mask (no
    selection), still divided by N k; gradient to the points only."""
    _check_points(pc, nn_size)
    _check_mask(pc, mask)
    return _RepulsionLossMasked.apply(pc, mask, nn_size, radius, h, eps)
