"""The port's one optimiser: optax's Adam in the arithmetic of the JAX
package's jitted steps.

`OptaxAdam` steps every trained or optimised tensor of the port: the
defense's points (`defense/ifdefense.py`), the CW attacks' variables
(`attack/cw.py`), the victims (`training.py`, with L2 decay and the cosine
schedule of `cosine_decay_schedule` through `ScheduledRate`) and the
occupancy networks (`implicit/training.py`). `torch.optim.Adam` takes
Adam's bias corrections 1 - b^t in float64; optax takes them in the
parameters' type, and in float32 1 - 0.999 is 0.00099998713, which moves
every update by about 6.5e-6 of itself.

The JAX package runs optax under `jit`, and XLA's CPU code does not do
optax's operations one at a time: it divides mu by the product of the two
denominators (`mu / (bc1 (sqrt(nu / bc2) + eps))`), contracts a product
and a sum into one fused multiply-add where the fusion lets it, and calls
the C library's `powf` and `cosf`. `OptaxAdam` and `cosine_decay_schedule`
do the same, a fused multiply-add as a float64 product of float32 values
(exact) plus the addend, rounded once to float32; so on the CPU the port's
updates, moments and rates are the bits of the JAX package's jitted
steps. On the card they are the CPU's but for torch's CUDA division of a
list by a scalar, which multiplies by the scalar's float32 reciprocal (a
unit in the last place off now and then).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Callable

import numpy as np
import torch


@functools.cache
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    lib.cosf.argtypes = [ctypes.c_float]
    lib.powf.restype = lib.cosf.restype = ctypes.c_float
    return lib


def bias_correction(b: float, t: int, dtype: torch.dtype) -> float:
    """optax's 1 - b^t in `dtype`: float32's power is `powf`, as XLA's
    on the CPU (numpy's float32 power is a unit in the last place away now
    and then); another type's is numpy's in that type."""
    if dtype == torch.float32:
        f = np.float32
        return float(f(1) - f(_libm().powf(b, t)))
    one = np.dtype(str(dtype).removeprefix("torch.")).type
    return float(one(1) - one(b) ** one(t))


class OptaxAdam(torch.optim.Optimizer):
    """optax's Adam in the parameters' type, as XLA's CPU code computes it
    in the JAX package's jitted steps (module docstring), fma(a, b, c)
    being a b + c rounded once: without `weight_decay` (`optax.adam(lr)`:
    the defense, the attacks, the occupancy networks)

        mu = fma(1 - b1, g, b1 mu),  nu = fma(1 - b2, g^2, b2 nu),

    and with it (the victims' `add_decayed_weights(wd)` -> `scale_by_adam`
    -> `scale_by_learning_rate(schedule)`, where XLA contracts nu's other
    product)

        g = fma(p, wd, g),  mu = fma(1 - b1, g, b1 mu),
        nu = fma(b2, nu, (1 - b2) g^2);

    then, both, p = fma(mu / (bc1 (sqrt(nu / bc2) + eps)), -lr, p), bc =
    1 - b^t (`bias_correction`). `lr` is the group's rate as a scheduler
    leaves it (`ScheduledRate`). In float64 the products round before the
    sums.

    State per parameter, torch's Adam's layout: `step` (an int; a restored
    state may hold torch's float tensor), `exp_avg`, `exp_avg_sq`. Scratch
    tensors live beside the state (two in the parameter's type, two in
    float64), made where they are missing, so a step allocates nothing
    (under deterministic algorithms each new tensor would cost a NaN fill)
    and a state loaded from a checkpoint
    (`utils.params_io.adam_state_from_jax`) resumes. The parameters of a
    group share one device and dtype (one `torch._foreach_*` call an
    operation)."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float | None = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.scratch: dict[torch.Tensor, tuple] = {}

    def _count(self, p: torch.Tensor) -> int:
        """p's state made whole where it is missing; -> its step count."""
        state = self.state[p]
        if "exp_avg" not in state:
            state.update(step=0, exp_avg=torch.zeros_like(p),
                         exp_avg_sq=torch.zeros_like(p))
        state["step"] = int(state["step"])
        if p not in self.scratch:
            self.scratch[p] = (torch.empty_like(p), torch.empty_like(p),
                               torch.empty_like(p, dtype=torch.float64),
                               torch.empty_like(p, dtype=torch.float64))
        return state["step"]

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            t = self._count(params[0]) + 1
            for p in params:
                self._count(p)
                self.state[p]["step"] = t
            self._update(params, group, t)

    def _update(self, params: list, group: dict, t: int) -> None:
        x, y, wa, wb = ([self.scratch[p][i] for p in params]
                        for i in range(4))
        mu = [self.state[p]["exp_avg"] for p in params]
        nu = [self.state[p]["exp_avg_sq"] for p in params]
        one = np.dtype(str(params[0].dtype).removeprefix("torch.")).type
        b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]

        def fma(out, a, scalar, c):
            """out = a scalar + c, rounded once (float32 a and scalar:
            their product is exact in float64)."""
            torch._foreach_copy_(wa, a)
            torch._foreach_mul_(wa, float(one(scalar)))
            torch._foreach_copy_(wb, c)
            torch._foreach_add_(wa, wb)
            torch._foreach_copy_(out, wa)

        grads = [p.grad for p in params]
        if wd is not None:                           # g + wd p
            fma(y, params, wd, grads)
            grads = y
        torch._foreach_copy_(x, mu)                  # (1 - b1) g + b1 mu
        torch._foreach_mul_(x, b1)
        fma(mu, grads, 1 - b1, x)
        torch._foreach_copy_(x, grads)               # (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(x, grads)
        if wd is None:
            torch._foreach_copy_(y, nu)
            torch._foreach_mul_(y, b2)
            fma(nu, x, 1 - b2, y)
        else:
            torch._foreach_mul_(x, 1 - b2)
            fma(nu, nu, b2, x)
        bc1, bc2 = (bias_correction(b, t, params[0].dtype) for b in (b1, b2))
        torch._foreach_copy_(x, nu)                  # bc1 (sqrt(nu / bc2)
        torch._foreach_div_(x, bc2)                  #      + eps)
        torch._foreach_copy_(wa, x)     # float32's sqrt, correctly rounded
        torch._foreach_sqrt_(wa)        # on the card and the CPU alike
        torch._foreach_copy_(x, wa)
        torch._foreach_add_(x, group["eps"])
        torch._foreach_mul_(x, bc1)
        torch._foreach_copy_(y, mu)                  # p - lr mu / x
        torch._foreach_div_(y, x)
        fma(params, y, -group["lr"], params)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          dtype: torch.dtype = torch.float32
                          ) -> Callable[[int], float]:
    """`optax.cosine_decay_schedule(init_value, decay_steps, alpha)` as
    XLA's CPU code computes it under `jit`, in the parameters' type (JAX
    takes float64 under x64): count -> init_value fma(1 + cos(min(count,
    T) pi_T), half, alpha), pi_T = pi (1 / T) and half = (1 - alpha) / 2
    folded into constants as XLA folds them, float32's cosine `cosf`;
    returned as a Python float that the type holds exactly. In float64
    the product rounds before the sum."""
    f = np.float32 if dtype == torch.float32 else np.float64
    cos = _libm().cosf if f is np.float32 else math.cos
    T = f(decay_steps)
    pi_T, half = f(np.pi) * (f(1) / T), f(1 - alpha) * f(0.5)

    def schedule(count: int) -> float:
        c = f(f(1) + f(cos(min(f(count), T) * pi_T)))
        decayed = f(np.float64(c) * np.float64(half) + np.float64(f(alpha)))
        return float(f(init_value) * decayed)

    return schedule


class ScheduledRate(torch.optim.lr_scheduler.LRScheduler):
    """Sets every group's rate to `schedule(count)`, count the scheduler's
    steps so far: after k optimiser and scheduler steps the next step takes
    the rate at count k, as optax's `scale_by_learning_rate(schedule)`
    reads its count before the step."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], last_epoch: int = -1):
        self.schedule = schedule
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> list[float]:
        return [self.schedule(self.last_epoch)
                for _ in self.optimizer.param_groups]
