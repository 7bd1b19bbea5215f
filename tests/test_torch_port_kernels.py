"""Plain PyTorch versions of the port's kernels against the JAX package.

B1-B3 (repulsion) are held to the Pallas kernels themselves, run in
interpret mode on the CPU (`fused_repulsion_*`, N a multiple of 256), not
to JAX's default CPU path (approx_max_k on bf16 distances). B4 (plane
sampling) is held to `bilinear_plane_sample` and to the interpret-mode
`fused_bilinear_plane_sample`.

The CUDA kernels are held to these plain versions on the card by
`tests/test_torch_port_cuda.py` and `chip_smoke.py`.

B1-B3 are also held to them on a lattice whose rows tie at their k-th
smallest distance (every d2 exact), for k in {1, 5, 8}: the case the
kernels' selection (a per-lane top-k merged across a warp) must count with
multiplicity.

Tolerances: losses rtol 1e-5 (atol 1e-9); gradients rtol 1e-4 with atol
1e-5 of the largest entry (pair terms summed in other orders); the B2 mask
bit-equal; B4 output and uv gradient atol 1e-5 in f32, its plane gradient
atol 1e-5 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.defense.repulsion import repulsion_knn as jax_repulsion_knn
from if_defense_tpu.defense.repulsion import repulsion_loss as jax_repulsion_loss
from if_defense_tpu.ops.interp import bilinear_plane_sample as jax_sample
from if_defense_tpu.ops.pallas_interp import fused_bilinear_plane_sample
from if_defense_tpu.ops.pallas_repulsion import (
    fused_repulsion_loss,
    fused_repulsion_loss_masked,
    fused_repulsion_mask,
)
from if_defense_tpu_torch.defense.repulsion import (
    repulsion_knn,
    repulsion_loss,
    repulsion_loss_masked,
    repulsion_loss_threshold,
    repulsion_mask,
)
from if_defense_tpu_torch.ops.interp import bilinear_plane_sample

N = 256


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """torch's CPU ops in one thread. Multi-threaded elementwise math has
    been seen to return one worker's chunk of a large tensor at low
    accuracy now and then (ROADMAP.md section C), which these tolerances
    would catch; in one thread the result does not depend on the split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed, duplicates=False):
    pc = np.random.default_rng(seed).uniform(-0.4, 0.4, (2, N, 3))
    pc = pc.astype(np.float32)
    if duplicates:                      # resampling repeats points
        pc[:, N // 2:] = pc[:, : N // 2]
    return pc


def _lattice(seed):
    """2 clouds of the 256 nodes of an 8 x 8 x 4 grid at spacing 1/16 (a
    power of two, so every d2 is exact in f32 and ties are real), each in
    its own random order."""
    rng = np.random.default_rng(seed)
    axes = [np.arange(s) - s // 2 for s in (8, 8, 4)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3) / 16
    assert len(grid) == N
    return np.stack([grid[rng.permutation(N)] for _ in range(2)]).astype(
        np.float32)


def _max_ties(pc, k):
    """The most distances equal to a row's k-th smallest, over all rows."""
    d2 = ((pc[:, :, None] - pc[:, None]) ** 2).sum(-1)
    d2[:, np.arange(N), np.arange(N)] = np.inf
    t = np.sort(d2, -1)[..., k - 1:k]
    return int((d2 == t).sum(-1).max())


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _torch_value_grad(fn, pc, w):
    p = torch.from_numpy(pc).requires_grad_(True)
    out = fn(p)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), p.grad.numpy()


def _jax_value_grad(fn, pc, w):
    p = jnp.asarray(pc)
    grad = jax.grad(lambda x: jnp.sum(fn(x) * jnp.asarray(w)))(p)
    return np.asarray(fn(p)), np.asarray(grad)


@pytest.mark.parametrize("duplicates", [False, True])
def test_b1_plain_matches_pallas(duplicates):
    pc = _points(0, duplicates)
    w = np.array([1.0, 2.5], np.float32)
    lt, gt = _torch_value_grad(repulsion_loss_threshold, pc, w)
    lj, gj = _jax_value_grad(fused_repulsion_loss, pc, w)
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-9)
    _grad_close(gt, gj)


def test_b2_plain_mask_equals_pallas():
    for seed, dup in ((1, False), (2, True)):
        pc = _points(seed, dup)
        got = repulsion_mask(torch.from_numpy(pc)).numpy()
        want = np.asarray(fused_repulsion_mask(jnp.asarray(pc)))
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)


def test_b3_plain_matches_pallas():
    pc = _points(3)
    mask = np.array(fused_repulsion_mask(jnp.asarray(pc)))
    moved = pc + np.random.default_rng(4).normal(
        scale=1e-3, size=pc.shape).astype(np.float32)
    w = np.array([0.7, 1.3], np.float32)
    lt, gt = _torch_value_grad(
        lambda p: repulsion_loss_masked(p, torch.from_numpy(mask)), moved, w)
    lj, gj = _jax_value_grad(
        lambda p: fused_repulsion_loss_masked(p, jnp.asarray(mask)), moved, w)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-9)
    _grad_close(gt, gj)


def test_exact_knn_repulsion_matches_jax():
    """The index-carrying path (exact_knn / knn_refresh > 1): the exact
    graph equal to JAX's `exact=True` one, and the loss over it."""
    pc = _points(7)
    w = np.array([0.9, 1.1], np.float32)
    np.testing.assert_array_equal(
        repulsion_knn(torch.from_numpy(pc)).numpy(),
        np.asarray(jax_repulsion_knn(jnp.asarray(pc), exact=True)))
    lt, gt = _torch_value_grad(repulsion_loss, pc, w)
    lj, gj = _jax_value_grad(
        lambda p: jax_repulsion_loss(p, exact=True), pc, w)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-9)
    _grad_close(gt, gj)


@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_b4_plain_matches_jax(reference):
    """Output, uv gradient and plane gradient; uv from [-0.1, 1.1], so that
    clamped queries (uv gradient 0) still add to the border cells."""
    rng = np.random.default_rng(5)
    plane = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (2, 256, 2)).astype(np.float32)
    g = rng.normal(size=(2, 256, 8)).astype(np.float32)
    fn = jax_sample if reference == "xla" else fused_bilinear_plane_sample
    want = fn(jnp.asarray(plane), jnp.asarray(uv))
    want_dp, want_du = jax.grad(
        lambda p, u: jnp.sum(fn(p, u) * jnp.asarray(g)), argnums=(0, 1))(
            jnp.asarray(plane), jnp.asarray(uv))
    p = torch.from_numpy(plane).requires_grad_(True)
    u = torch.from_numpy(uv).requires_grad_(True)
    got = bilinear_plane_sample(p, u)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(want_du),
                               rtol=0, atol=1e-5 * np.abs(want_du).max())
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_dp),
                               rtol=0, atol=1e-5 * np.abs(want_dp).max())
    assert np.abs(np.asarray(want_dp)[:, 0, 0]).sum() > 0   # border cells hit


@pytest.mark.parametrize("k", [1, 5, 8])
def test_b1_plain_matches_pallas_on_ties(k):
    pc = _lattice(10 + k)
    assert _max_ties(pc, k) > 1
    w = np.array([1.0, 2.5], np.float32)
    lt, gt = _torch_value_grad(
        lambda p: repulsion_loss_threshold(p, k), pc, w)
    lj, gj = _jax_value_grad(lambda p: fused_repulsion_loss(p, k), pc, w)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-9)
    _grad_close(gt, gj)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_b2_plain_mask_equals_pallas_on_ties(k):
    pc = _lattice(20 + k)
    got = repulsion_mask(torch.from_numpy(pc), k).numpy()
    want = np.asarray(fused_repulsion_mask(jnp.asarray(pc), k))
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) > k).any()          # tied rows keep every tie


@pytest.mark.parametrize("k", [1, 5, 8])
def test_b3_plain_matches_pallas_on_ties(k):
    pc = _lattice(30 + k)
    mask = np.array(fused_repulsion_mask(jnp.asarray(pc), k))
    w = np.array([0.7, 1.3], np.float32)
    lt, gt = _torch_value_grad(
        lambda p: repulsion_loss_masked(p, torch.from_numpy(mask), k), pc, w)
    lj, gj = _jax_value_grad(
        lambda p: fused_repulsion_loss_masked(p, jnp.asarray(mask), k), pc, w)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-9)
    _grad_close(gt, gj)
