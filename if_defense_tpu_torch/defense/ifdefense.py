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


def occupancy_bce(logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """BCE-with-logits against the soft occupancy target, mean over all."""
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, threshold))


class Adam:
    """optax.adam: scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    bias-corrected) then scale by -lr, state in the points' type (f32)."""

    def __init__(self, p: torch.Tensor, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = torch.zeros_like(p)
        self.nu = torch.zeros_like(p)
        self.count = 0

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        self.count += 1
        self.mu = (1 - self.b1) * g + self.b1 * self.mu
        self.nu = (1 - self.b2) * (g * g) + self.b2 * self.nu
        mu_hat = self.mu / (1 - self.b1**self.count)
        nu_hat = self.nu / (1 - self.b2**self.count)
        return p + (-self.lr) * (mu_hat / (nu_hat.sqrt() + self.eps))


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
    stats=None) -> [B, sample_npoint, 3].

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

    def defend(model, pc: torch.Tensor, generator: torch.Generator | None = None,
               draws=None, stats: dict | None = None) -> torch.Tensor:
        if draws is None:
            if generator is None:
                raise ValueError("defend needs a generator or draws")
            if sor:
                pc, mask = sor_defense(pc, sor_k, sor_alpha)
            else:
                mask = torch.ones(pc.shape[:2], dtype=pc.dtype,
                                  device=pc.device)
            proc = normalize_unit_cube(pc, padding_scale, mask)
            sel = sample_valid(proc, mask, input_npoint, generator)
            pts = sample_valid(proc, mask, sample_npoint, generator)
            noise = torch.randn(pts.shape, generator=generator,
                                device=pts.device, dtype=pts.dtype)
            pts = (pts + noise * init_sigma).clamp(
                -0.5 * padding_scale, 0.5 * padding_scale)
        else:
            sel, pts = draws

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
            occ_loss = occupancy_bce(occ.float(), threshold) * sample_npoint
            if rep_mask is not None:
                rep_each = repulsion_loss_masked_auto(p, rep_mask)
            elif use_fused:
                rep_each = repulsion_loss_auto(p)
            else:
                rep_each = repulsion_loss_with_idx(p, idx)
            rep = rep_each.float().mean() * rep_weight
            return occ_loss + rep, occ_loss

        adam = Adam(pts, lr)

        def step(p, i, idx, cache=None, rep_mask=None):
            p = p.detach().requires_grad_(True)
            loss, occ_loss = loss_fn(p, idx, cache, rep_mask)
            (grad,) = torch.autograd.grad(loss, p)
            if stats is not None and i in (0, iterations):
                key = "occ_loss_first" if i == 0 else "occ_loss_last"
                stats[key] = occ_loss.detach()
            return adam.step(p.detach(), grad)

        def refresh(p, i, idx):
            if use_fused or i % knn_refresh:
                return idx
            return repulsion_knn(p)

        p = pts
        idx = None if use_fused else repulsion_knn(pts)
        if not use_cache:
            # the reference runs range(iterations + 1): 201 steps
            for i in range(iterations + 1):
                idx = refresh(p, i, idx)
                p = step(p, i, idx)
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
                    idx = refresh(p, i, idx)
                p = step(p, i, idx, cache, rep_mask)
        return normalize_unit_sphere(p)

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
    """ConvONet-Opt: (pc, generator=None, draws=None, stats=None) ->
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
    """ONet-Opt (z_dim 0): (pc, generator=None, draws=None, stats=None) ->
    restored clouds; 300 encoder points unless `input_npoint` says
    otherwise."""
    kwargs.setdefault("input_npoint", 300)
    return _model_opt_defense(model, **kwargs)


def _model_opt_defense(model, **kwargs):
    defend = make_opt_defense(
        lambda m, p, c: m.decode(p, c),
        lambda m, pc: m.encode_inputs(pc),
        **kwargs)
    return functools.partial(defend, model)
