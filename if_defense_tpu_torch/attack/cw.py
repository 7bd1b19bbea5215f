"""CW optimisation attacks: Perturb, Add and kNN (port of
`if_defense_tpu/attack/cw.py`).

The binary search over the distance weight (`Perturb.py:154-162`) wraps
`num_iter` Adam iterations of the victim's forward and backward; each
iteration records, per example, the iterate whose logits it has just
evaluated when it succeeds at a smaller distance than the best so far,
then takes the Adam step. Examples that never succeed fall back to the
final iterate of the last binary step. The JAX package runs all of it as
one jitted scan of scans; here each iteration launches eagerly, and the
bookkeeping stays on the device (`torch.where`), so the loop never waits
for the card.

The optimiser is optax's Adam in optax's arithmetic (`optim.OptaxAdam`:
b1 0.9, b2 0.999, eps 1e-8, the bias corrections in float32), a fresh one
at each binary step as JAX re-inits its state. `device_chunk_iters` keeps
the JAX package's meaning and check (an int R runs the loop in R-iteration
segments; it must be >= 1): eager PyTorch launches every iteration either
way, so the results do not depend on it.

Random draws come from `generator`; the `draws` seam takes them from the
caller instead (the tests hand over JAX's): the standard normals of the
1e-7 init noise, [binary_step, ...] for the binary searches.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
from torch.nn import functional as F

from if_defense_tpu_torch.attack.clip import project_inner_clip_linf
from if_defense_tpu_torch.attack.losses import (
    batch_mean,
    l2_dist,
    logits_adv_loss,
)
from if_defense_tpu_torch.ops import index_points
from if_defense_tpu_torch.optim import OptaxAdam

BIG = 1e10


def cw_chunk_sizes(num_iter: int, chunk: int | None) -> list[int]:
    """Iterations per segment: [num_iter] for None, else segments of
    `chunk` and the remainder. Refuses chunk < 1 (a negative "auto"
    leaking through would otherwise run no iteration at all)."""
    if chunk is None:
        return [num_iter]
    if chunk < 1:
        raise ValueError(
            f"device_chunk_iters must be >= 1, got {chunk} "
            "(use None for one segment)")
    sizes = [chunk] * (num_iter // chunk)
    if num_iter % chunk:
        sizes.append(num_iter % chunk)
    return sizes


def adam(params: Sequence[torch.Tensor], lr: float) -> OptaxAdam:
    """`optax.adam(lr)` at its defaults."""
    return OptaxAdam(params, lr=lr)


def normal_like(x: torch.Tensor, generator: torch.Generator | None,
                shape=None) -> torch.Tensor:
    """Standard normals of x's type and device (of `shape`, else x's)."""
    if generator is None:
        raise ValueError("the attack needs a generator or draws")
    return torch.randn(x.shape if shape is None else shape,
                       generator=generator, dtype=x.dtype, device=x.device)


def step_normals(x: torch.Tensor, binary_step: int,
                 generator: torch.Generator | None,
                 shape=None) -> torch.Tensor:
    """[binary_step, *shape] standard normals of x's type and device (x's
    shape by default), one draw a binary step: the draws `step_noise`
    takes from `generator`, in its order."""
    return torch.stack([normal_like(x, generator, shape)
                        for _ in range(binary_step)])


def step_noise(x: torch.Tensor, binary_step: int,
               generator: torch.Generator | None,
               draws: torch.Tensor | None) -> Callable[[int], torch.Tensor]:
    """step -> x plus 1e-7 noise: draws[step], the draws from
    `step_normals` where none are given."""
    if draws is None:
        draws = step_normals(x, binary_step, generator)
    if draws.shape[0] != binary_step:
        raise ValueError(f"draws hold {draws.shape[0]} binary steps, not "
                         f"{binary_step}")
    return lambda step: x + draws[step] * 1e-7


def cw_binary_search(
    logits_from_adv: Callable,
    dist_fn: Callable,
    adv_fn: Callable,
    init_adv: Callable[[int], Sequence[torch.Tensor]],
    target: torch.Tensor,
    *,
    attack_lr: float,
    init_weight: float,
    max_weight: float,
    binary_step: int,
    num_iter: int,
    record_fn: Callable | None = None,
    postprocess_fn: Callable | None = None,
    device_chunk_iters: int | None = None,
):
    """The CW core shared by every CW attack (`cw.py:37-151` of the JAX
    package).

    Args:
        logits_from_adv: the adversarial variables (a list of tensors) ->
            [B, C] logits.
        dist_fn: the variables -> [B] distance (recorded, and weighted into
            the loss).
        adv_fn: (logits, target) -> [B] adversarial loss.
        init_adv: binary step -> the fresh variables of that step.
        record_fn: the variables -> the [B, ...] tensor recorded as the
            attack (default: the first variable; the object attack records
            its transformed points).
        postprocess_fn: applied in place to the variables after each Adam
            step (the object attack's angle wrap).
    Returns:
        (best distance [B], best attack (record-shaped), success [B]).
    """
    B = target.shape[0]
    dev = target.device
    if record_fn is None:
        record_fn = lambda adv: adv[0]
    sizes = cw_chunk_sizes(num_iter, device_chunk_iters)
    lower = torch.zeros(B, device=dev)
    upper = torch.full((B,), max_weight, device=dev)
    weight = torch.full((B,), init_weight, device=dev)
    obd = torch.full((B,), BIG, device=dev)
    oba = last_rec = None
    for step in range(binary_step):
        adv = [x.detach().clone().requires_grad_(True)
               for x in init_adv(step)]
        opt = adam(adv, attack_lr)
        bd = torch.full((B,), BIG, device=dev)
        bs = torch.full((B,), -1, dtype=torch.long, device=dev)
        for length in sizes:
            for _ in range(length):
                logits = logits_from_adv(adv).float()
                per_dist = dist_fn(adv).float()
                loss = (batch_mean(adv_fn(logits, target))
                        + batch_mean(weight * per_dist))
                grads = torch.autograd.grad(loss, adv)
                with torch.no_grad():
                    pred = logits.argmax(dim=-1)
                    succ = pred == target
                    dist = per_dist.detach()
                    better = succ & (dist < bd)
                    bd = torch.where(better, dist, bd)
                    bs = torch.where(better, pred, bs)
                    o_better = succ & (dist < obd)
                    obd = torch.where(o_better, dist, obd)
                    rec = record_fn(adv).detach()
                    if oba is None:
                        oba = torch.zeros_like(rec)
                    oba = torch.where(
                        o_better.reshape((B,) + (1,) * (rec.dim() - 1)), rec,
                        oba)
                    for p, g in zip(adv, grads):
                        p.grad = g
                    opt.step()
                    if postprocess_fn is not None:
                        postprocess_fn(adv)
        # bisection on the budget weight (Perturb.py:154-162)
        succ = (bs == target) & (bs != -1) & (bd <= obd)
        lower = torch.where(succ, torch.maximum(lower, weight), lower)
        upper = torch.where(succ, upper, torch.minimum(upper, weight))
        weight = (lower + upper) / 2.0
        with torch.no_grad():
            last_rec = record_fn(adv).detach()
    # examples that never succeeded fall back to the final iterate
    fail = lower == 0.0
    if oba is None:                    # no iteration ran
        oba = torch.zeros_like(last_rec)
    oba = torch.where(fail.reshape((B,) + (1,) * (oba.dim() - 1)), last_rec,
                      oba)
    return obd, oba, ~fail


def cw_perturb(
    logits_fn: Callable,
    data: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator | None = None,
    dist_fn: Callable = l2_dist,
    adv_fn: Callable = logits_adv_loss,
    attack_lr: float = 1e-2,
    init_weight: float = 10.0,
    max_weight: float = 80.0,
    binary_step: int = 10,
    num_iter: int = 500,
    device_chunk_iters: int | None = None,
    draws: torch.Tensor | None = None,
):
    """CW point-perturbation attack (CVPR'19, `CW/Perturb.py:13-175`).

    Args:
        logits_fn: [B, K, 3] -> [B, C] victim forward (autograd on).
        data: [B, K, 3] clean clouds; target: [B] target labels.
        draws: optional init normals [binary_step, B, K, 3].
    Returns:
        (best distance [B], adv [B, K, 3], success [B]).
    """
    ori = data
    init = step_noise(ori, binary_step, generator, draws)
    return cw_binary_search(
        lambda adv: logits_fn(adv[0]),
        lambda adv: dist_fn(adv[0], ori),
        adv_fn, lambda step: [init(step)], target,
        attack_lr=attack_lr, init_weight=init_weight, max_weight=max_weight,
        binary_step=binary_step, num_iter=num_iter,
        device_chunk_iters=device_chunk_iters)


def get_critical_points(logits_fn: Callable, data: torch.Tensor,
                        label: torch.Tensor, num: int) -> torch.Tensor:
    """The `num` points of largest squared input gradient of the cross
    entropy toward `label` (`CW/Add.py:14-42`), [B, num, 3]. Ties go to
    the lower index, as `lax.top_k`'s do: a stable sort."""
    p = data.detach().requires_grad_(True)
    logp = F.log_softmax(logits_fn(p), dim=-1)
    loss = -batch_mean(logp.gather(-1, label.long()[:, None])[:, 0])
    (grad,) = torch.autograd.grad(loss, p)
    mag = (grad * grad).sum(dim=-1)                          # [B, K]
    idx = torch.sort(mag, dim=1, descending=True, stable=True).indices
    return index_points(data, idx[:, :num])


def add_search(logits_fn: Callable, dist_fn: Callable, adv_fn: Callable,
               ori: torch.Tensor, init: Callable[[int], torch.Tensor],
               target: torch.Tensor, **kwargs):
    """The binary search of the adding attacks: the variable is the added
    points, the victim sees them after the clean cloud, and `dist_fn(added,
    ori)` is the budget. -> (best distance, ori + best added, success)."""
    obd, best_added, success = cw_binary_search(
        lambda adv: logits_fn(torch.cat([ori, adv[0]], dim=1)),
        lambda adv: dist_fn(adv[0], ori),
        adv_fn, lambda step: [init(step)], target, **kwargs)
    return obd, torch.cat([ori, best_added], dim=1), success


def cw_add(
    logits_fn: Callable,
    data: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator | None = None,
    dist_fn: Callable | None = None,
    adv_fn: Callable = logits_adv_loss,
    num_add: int = 512,
    attack_lr: float = 1e-2,
    init_weight: float = 5e3,
    max_weight: float = 4e4,
    binary_step: int = 10,
    num_iter: int = 500,
    device_chunk_iters: int | None = None,
    draws: torch.Tensor | None = None,
):
    """CW point-adding attack (CVPR'19, `CW/Add.py:45-220`): `num_add`
    points, started at the gradient-critical points, optimised under
    `dist_fn(added, ori)` (Chamfer or Hausdorff). `draws`: init normals
    [binary_step, B, num_add, 3].

    Returns:
        (best distance [B], adv [B, K + num_add, 3], success [B]).
    """
    cri = get_critical_points(logits_fn, data, target, num_add)
    return add_search(
        logits_fn, dist_fn, adv_fn, data,
        step_noise(cri, binary_step, generator, draws), target,
        attack_lr=attack_lr, init_weight=init_weight, max_weight=max_weight,
        binary_step=binary_step, num_iter=num_iter,
        device_chunk_iters=device_chunk_iters)


def cw_knn(
    logits_fn: Callable,
    data: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator | None = None,
    dist_fn: Callable | None = None,
    normal: torch.Tensor | None = None,
    adv_fn: Callable | None = None,
    attack_lr: float = 1e-3,
    num_iter: int = 2500,
    budget: float = 0.1,
    kappa: float = 15.0,
    device_chunk_iters: int | None = None,
    draws: torch.Tensor | None = None,
):
    """CW kNN attack (AAAI'20, `CW/kNN.py:14-149`): no binary search;
    `num_iter` Adam steps on adv_loss + K * dist, each followed by the
    projection of inside points to the surface (by the `normal`s) and the
    per-point clip to `budget`. kappa 15 is the margin of the reference's
    attack script (`targeted_knn_attack.py:81`). `draws`: init normals
    [B, K, 3].

    Returns:
        (adv [B, K, 3], success [B]).
    """
    K = data.shape[1]
    ori = data
    if adv_fn is None:
        adv_fn = functools.partial(logits_adv_loss, kappa=kappa)
    noise = normal_like(ori, generator) if draws is None else draws
    adv = (ori + noise * 1e-7).requires_grad_(True)
    opt = adam([adv], attack_lr)
    for length in cw_chunk_sizes(num_iter, device_chunk_iters):
        for _ in range(length):
            loss = (batch_mean(adv_fn(logits_fn(adv), target))
                    + batch_mean(dist_fn(adv, ori)) * K)
            (adv.grad,) = torch.autograd.grad(loss, [adv])
            with torch.no_grad():
                opt.step()
                adv.copy_(project_inner_clip_linf(adv, ori, normal, budget))
    adv = adv.detach()
    with torch.no_grad():
        return adv, logits_fn(adv).argmax(dim=-1) == target
