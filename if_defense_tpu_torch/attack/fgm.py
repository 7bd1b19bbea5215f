"""FGM-family gradient attacks: FGM, I-FGM, MI-FGM and PGD (port of
`if_defense_tpu/attack/fgm.py`), on channel-last [B, K, 3] clouds.

Each step descends the gradient of the targeted adversarial loss,
normalised to unit global L2 per cloud, and clips back into the budget
ball around the start; MI-FGM accumulates L1-normalised gradients with
momentum; PGD is I-FGM from a uniform random start within budget /
sqrt(K * 3) per coordinate, its ball centred on that start as in the JAX
package.

Random draws come from `generator`; the `draws` seam takes them from the
caller instead (the tests hand over JAX's): standard normals for the 1e-7
start noise, and for PGD also uniforms in [0, 1) for its start.
"""

from __future__ import annotations

from typing import Callable

import torch

from if_defense_tpu_torch.attack.clip import clip_points_l2
from if_defense_tpu_torch.attack.losses import batch_mean, logits_adv_loss


def _global_l2(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=(1, 2)).sqrt()


def _adv_grad(logits_fn, adv_fn, pc, target, normalize=True):
    p = pc.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(batch_mean(adv_fn(logits_fn(p), target)), p)
    if normalize:
        g = g / (_global_l2(g)[:, None, None] + 1e-9)
    return g


def _success(logits_fn, adv, target):
    with torch.no_grad():
        return logits_fn(adv).argmax(dim=-1) == target


def _normal(shape, like: torch.Tensor, generator) -> torch.Tensor:
    if generator is None:
        raise ValueError("the attack needs a generator or draws")
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def fgm(logits_fn: Callable, data: torch.Tensor, target: torch.Tensor,
        budget: float, adv_fn: Callable = logits_adv_loss):
    """Single-step FGM. -> (adv [B, K, 3], success [B])."""
    adv = data - _adv_grad(logits_fn, adv_fn, data, target) * budget
    return adv, _success(logits_fn, adv, target)


def _iterative(logits_fn, adv_fn, data, target, noise, budget, step_size,
               num_iter, momentum_mu=None):
    ori = data + noise * 1e-7
    pc, mom = ori, torch.zeros_like(ori)
    for _ in range(num_iter):
        if momentum_mu is None:
            direction = _adv_grad(logits_fn, adv_fn, pc, target)
        else:
            g = _adv_grad(logits_fn, adv_fn, pc, target, normalize=False)
            g = g / (g.abs().sum(dim=(1, 2))[:, None, None] + 1e-9)
            mom = momentum_mu * mom + g
            direction = mom / (_global_l2(mom)[:, None, None] + 1e-9)
        pc = clip_points_l2(pc - step_size * direction, ori, budget)
    return pc, _success(logits_fn, pc, target)


def ifgm(logits_fn: Callable, data: torch.Tensor, target: torch.Tensor,
         budget: float, step_size: float, num_iter: int = 50,
         adv_fn: Callable = logits_adv_loss,
         generator: torch.Generator | None = None,
         draws: torch.Tensor | None = None):
    """Iterative FGM with a global L2 clip each step; `draws` is the start
    noise's standard normals [B, K, 3]. -> (adv, success)."""
    noise = _normal(data.shape, data, generator) if draws is None else draws
    return _iterative(logits_fn, adv_fn, data, target, noise, budget,
                      step_size, num_iter)


def mifgm(logits_fn: Callable, data: torch.Tensor, target: torch.Tensor,
          budget: float, step_size: float, num_iter: int = 50,
          mu: float = 1.0, adv_fn: Callable = logits_adv_loss,
          generator: torch.Generator | None = None,
          draws: torch.Tensor | None = None):
    """Momentum iterative FGM; `draws` as `ifgm`'s. -> (adv, success)."""
    noise = _normal(data.shape, data, generator) if draws is None else draws
    return _iterative(logits_fn, adv_fn, data, target, noise, budget,
                      step_size, num_iter, momentum_mu=mu)


def pgd_draws(data: torch.Tensor, generator: torch.Generator | None):
    """(uniforms in [0, 1), standard normals), each of data's shape: the
    draws `pgd` takes from `generator`, in its order."""
    if generator is None:
        raise ValueError("the attack needs a generator or draws")
    u = torch.rand(data.shape, generator=generator, dtype=data.dtype,
                   device=data.device)
    return u, _normal(data.shape, data, generator)


def pgd(logits_fn: Callable, data: torch.Tensor, target: torch.Tensor,
        budget: float, step_size: float, num_iter: int = 50,
        adv_fn: Callable = logits_adv_loss,
        generator: torch.Generator | None = None,
        draws: tuple[torch.Tensor, torch.Tensor] | None = None):
    """PGD: I-FGM from a uniform start within budget / sqrt(K * 3) per
    coordinate; `draws` is (uniforms in [0, 1), standard normals), both
    [B, K, 3]. -> (adv, success)."""
    u, noise = pgd_draws(data, generator) if draws is None else draws
    eps = budget / (data.shape[1] * data.shape[2]) ** 0.5
    # jax.random.uniform's map in f32: max(u * (max - min) + min, min)
    lo = torch.full((), -eps, dtype=data.dtype, device=data.device)
    start = torch.maximum(u * (-2.0 * lo) + lo, lo)
    return _iterative(logits_fn, adv_fn, data + start, target, noise, budget,
                      step_size, num_iter)
