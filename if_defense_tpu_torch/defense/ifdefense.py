"""IF-Defense optimisation-based restoration, ConvONet-Opt and ONet-Opt
(port of `if_defense_tpu/defense/ifdefense.py`).

  1. optional SOR (k=2, alpha=1.1) -> validity mask
  2. per-cloud centre + scale into the padded unit cube (padding_scale 0.9)
  3. encode a fixed-size subset (600 ConvONet / 300 ONet points) once -> c
  4. init 1024 optimisation points = resample of the (masked) input +
     N(0, 0.01) noise, clamped to +-0.45
  5. 201 Adam(lr 1e-3) steps minimising
        K * mean BCE(decode(points, c), threshold=0.2)
      + 500 * mean repulsion(points)
  6. renormalise to the unit sphere

The JAX package jits all of this into one function with a `lax.scan`; the
port runs it eagerly, one Python step at a time. Random draws come from a
`torch.Generator` (`jax.random` cannot be reproduced); the `draws` seam of
the returned function takes the encoder subset and the initial points from
the caller instead, so tests can hand the port JAX's own draws.

Differences from the JAX package, all deliberate:
- `rep_graph_cache` without the corner-cache functions raises (JAX drops
  the request silently);
- the repulsion kNN of the index-carrying path (`exact_knn`, or
  `knn_refresh > 1`) is always exact (see `defense/repulsion.py`).
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable

import torch
from torch.nn import functional as F

from if_defense_tpu_torch.defense.repulsion import (
    repulsion_knn,
    repulsion_loss_auto,
    repulsion_loss_masked_auto,
    repulsion_loss_with_idx,
    repulsion_mask_auto,
)
from if_defense_tpu_torch.defense.sor import sor_defense
from if_defense_tpu_torch.ops import (
    cached_bilinear_sample,
    index_points,
    normalize_coordinate,
    normalize_unit_cube,
    normalize_unit_sphere,
    plane_corner_features,
)
from if_defense_tpu_torch.optim import OptaxAdam


def sample_valid(pc: torch.Tensor, mask: torch.Tensor, n: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Randomly sample `n` valid points per cloud (duplicating if short):
    valid points first in a random order, then cycled."""
    B, K, _ = pc.shape
    u = torch.rand((B, K), generator=generator, device=pc.device,
                   dtype=pc.dtype)
    order = torch.argsort((1.0 - mask) * 2.0 + u, dim=1)
    cnt = mask.sum(dim=1).long().clamp_min(1)
    j = torch.arange(n, device=pc.device)
    return index_points(pc, order.gather(1, j[None, :] % cnt[:, None]))


def occupancy_bce(logits: torch.Tensor, threshold: float,
                  count: int) -> torch.Tensor:
    """BCE-with-logits against the soft occupancy target: the sum over
    these logits divided by `count`, the logits of the whole batch (so a
    shard's part of the batch's mean; the mean for the whole batch)."""
    return _ShardBCE.apply(logits, torch.full_like(logits, threshold), count)


class _ShardBCE(torch.autograd.Function):
    """A shard's part of the mean BCE over the whole batch. Its gradient,
    `(sigmoid(x) - t) * g / count`, is rounded as the built-in mean's
    backward rounds it, so each logit gets the bits the unsplit batch
    gives it."""

    @staticmethod
    def forward(ctx, logits, target, count):
        ctx.save_for_backward(logits, target)
        ctx.count = count
        return F.binary_cross_entropy_with_logits(
            logits, target, reduction="sum") / count

    @staticmethod
    def backward(ctx, g):
        logits, target = ctx.saved_tensors
        return (logits.sigmoid() - target) * g / ctx.count, None, None


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: v.to(dtype) for k, v in tree.items()}
    return tree.to(dtype)


def make_opt_defense(
    decode_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
    encode_fn: Callable[[Any, torch.Tensor], Any],
    *,
    input_npoint: int = 600,
    sample_npoint: int = 1024,
    padding_scale: float = 0.9,
    init_sigma: float = 0.01,
    iterations: int = 200,
    lr: float = 1e-3,
    rep_weight: float = 500.0,
    threshold: float = 0.2,
    sor: bool = True,
    sor_k: int = 2,
    sor_alpha: float = 1.1,
    exact_knn: bool = False,
    knn_refresh: int = 1,
    compute_dtype: str | None = None,
    interp_refresh: int = 1,
    corner_cache_fn: Callable | None = None,
    decode_cached_fn: Callable | None = None,
    rep_graph_cache: bool = False,
):
    """Build the defense: (model, pc [B, K, 3], generator=None, draws=None,
    stats=None, batch_total=None) -> [B, sample_npoint, 3].

    `encode_fn(model, pc)` / `decode_fn(model, p, c)` apply the frozen
    implicit model. `draws=(sel [B, input_npoint, 3], pts [B,
    sample_npoint, 3])` replaces the random encoder subset and initial
    points (after noise and clamp); otherwise they are drawn from
    `generator`. A `stats` dict receives the occupancy loss of the first and
    the last step (`occ_loss_first`, `occ_loss_last`, 0-d tensors).

    Modes as in the JAX package: `knn_refresh` / `exact_knn` select the
    index-carrying repulsion path; `compute_dtype="bfloat16"` runs the
    decoder and repulsion in bf16 with f32 master points and Adam state;
    `interp_refresh=R > 1` re-lerps cached bilinear corners for R steps;
    `rep_graph_cache` freezes the repulsion neighbour mask per window.

    Sharding a batch (`parallel`): `defend.draw(pc, generator)` makes the
    draws of the whole batch as `defend` would (SOR, unit cube, the subset,
    the noisy initial points), to be split and handed to each shard's
    `defend` as `draws`; `batch_total`, the whole batch's cloud count
    (this call's own B by default), is what the loss's means over the
    batch divide by, so a shard's gradients are the unsplit batch's. The
    shard's `stats` are then its parts of the batch's losses, which sum
    to them.
    """
    if rep_graph_cache and interp_refresh <= 1:
        raise ValueError(
            "rep_graph_cache refreshes the neighbour graph on the "
            "corner-cache cadence; it requires interp_refresh > 1")
    use_cache = (interp_refresh > 1 and corner_cache_fn is not None
                 and decode_cached_fn is not None)
    if rep_graph_cache and not use_cache:
        raise ValueError(
            "rep_graph_cache needs corner_cache_fn and decode_cached_fn")
    cd = getattr(torch, compute_dtype) if compute_dtype else None
    # the fused kernels cover graph-refresh-every-step with exact selection;
    # exact_knn / knn_refresh > 1 keep the index-carrying path
    use_fused = knn_refresh == 1 and not exact_knn

    def draw(pc: torch.Tensor, generator: torch.Generator):
        """(encoder subset [B, input_npoint, 3], initial points [B,
        sample_npoint, 3]) of the batch, drawn from `generator`."""
        if generator is None:
            raise ValueError("defend needs a generator or draws")
        if sor:
            pc, mask = sor_defense(pc, sor_k, sor_alpha)
        else:
            mask = torch.ones(pc.shape[:2], dtype=pc.dtype, device=pc.device)
        proc = normalize_unit_cube(pc, padding_scale, mask)
        sel = sample_valid(proc, mask, input_npoint, generator)
        pts = sample_valid(proc, mask, sample_npoint, generator)
        noise = torch.randn(pts.shape, generator=generator,
                            device=pts.device, dtype=pts.dtype)
        pts = (pts + noise * init_sigma).clamp(
            -0.5 * padding_scale, 0.5 * padding_scale)
        return sel, pts

    def defend(model, pc: torch.Tensor, generator: torch.Generator | None = None,
               draws=None, stats: dict | None = None,
               batch_total: int | None = None) -> torch.Tensor:
        sel, pts = draw(pc, generator) if draws is None else draws
        total = len(pts) if batch_total is None else batch_total

        # frozen, and in eval mode: ONet's batch norms use running stats
        loop_model = copy.deepcopy(model).requires_grad_(False).eval()
        with torch.no_grad():
            c = encode_fn(loop_model, sel)
        if cd is not None:
            loop_model = loop_model.to(cd)
            c = _cast(c, cd)

        def loss_fn(p, idx, cache, rep_mask):
            if cd is not None:
                p = p.to(cd)
            if cache is None:
                occ = decode_fn(loop_model, p, c)
            else:
                occ = decode_cached_fn(loop_model, p, c, cache)
            occ_loss = occupancy_bce(occ.float(), threshold,
                                     total * sample_npoint) * sample_npoint
            if rep_mask is not None:
                rep_each = repulsion_loss_masked_auto(p, rep_mask)
            elif use_fused:
                rep_each = repulsion_loss_auto(p)
            else:
                rep_each = repulsion_loss_with_idx(p, idx)
            rep = rep_each.float().sum() / total * rep_weight
            return occ_loss + rep, occ_loss

        # the points, stepped in place by optax's Adam (f32 state)
        p = pts.clone()
        adam = OptaxAdam([p], lr)

        def step(i, idx, cache=None, rep_mask=None):
            q = p.detach().requires_grad_(True)
            loss, occ_loss = loss_fn(q, idx, cache, rep_mask)
            (p.grad,) = torch.autograd.grad(loss, q)
            if stats is not None and i in (0, iterations):
                key = "occ_loss_first" if i == 0 else "occ_loss_last"
                stats[key] = occ_loss.detach()
            adam.step()

        def refresh(i, idx):
            if use_fused or i % knn_refresh:
                return idx
            return repulsion_knn(p)

        idx = None if use_fused else repulsion_knn(pts)
        if not use_cache:
            # the reference runs range(iterations + 1): 201 steps
            for i in range(iterations + 1):
                idx = refresh(i, idx)
                step(i, idx)
            return normalize_unit_sphere(p)

        n_blocks, tail = divmod(iterations + 1, interp_refresh)
        windows = [(b * interp_refresh, interp_refresh)
                   for b in range(n_blocks)]
        if tail:
            windows.append((n_blocks * interp_refresh, tail))
        for start, length in windows:
            with torch.no_grad():
                cache = corner_cache_fn(
                    loop_model, p.to(cd) if cd is not None else p, c)
                # the graph comes from the f32 window-start points
                rep_mask = repulsion_mask_auto(p) if rep_graph_cache else None
            for i in range(start, start + length):
                if not rep_graph_cache:
                    idx = refresh(i, idx)
                step(i, idx, cache, rep_mask)
        return normalize_unit_sphere(p)

    defend.draw = draw
    return defend


def _convonet_corner_fns(padding: float):
    """(corner_cache_fn, decode_cached_fn) for the interp_refresh path."""
    def corner_cache(model, p, c):
        return {pl: plane_corner_features(
                    plane, normalize_coordinate(p, pl, padding))
                for pl, plane in c.items()}

    def decode_cached(model, p, c, cache):
        feat = 0
        for pl, plane in c.items():
            uv = normalize_coordinate(p, pl, padding)
            feat = feat + cached_bilinear_sample(
                *cache[pl], uv, plane.shape[1:3])
        return model.decode_head(p, feat)

    return corner_cache, decode_cached


def convonet_opt_defense(model, **kwargs):
    """ConvONet-Opt: (pc, generator=None, draws=None, stats=None,
    batch_total=None) ->
    restored clouds. `interp_refresh > 1` enables the corner-cache decoder
    fast path for plane latents; a `grid` latent keeps the exact path (the
    reference mode's steps)."""
    if kwargs.get("interp_refresh", 1) > 1 and "grid" not in model.plane_type:
        cache_fn, cached_fn = _convonet_corner_fns(model.padding)
        kwargs.setdefault("corner_cache_fn", cache_fn)
        kwargs.setdefault("decode_cached_fn", cached_fn)
    kwargs.setdefault("input_npoint", 600)
    return _model_opt_defense(model, **kwargs)


def onet_opt_defense(model, **kwargs):
    """ONet-Opt (z_dim 0): (pc, generator=None, draws=None, stats=None,
    batch_total=None) ->
    restored clouds; 300 encoder points unless `input_npoint` says
    otherwise."""
    kwargs.setdefault("input_npoint", 300)
    return _model_opt_defense(model, **kwargs)


def _model_opt_defense(model, **kwargs):
    defend = make_opt_defense(
        lambda m, p, c: m.decode(p, c),
        lambda m, pc: m.encode_inputs(pc),
        **kwargs)
    out = functools.partial(defend, model)
    out.draw = defend.draw
    return out
