"""The encoder's scatter-mean in a fixed order, PyTorch port vs JAX
package, on the CPU.

`ops.scatter.scatter_mean_2d` is an autograd Function: its forward is the
CUDA kernel `csrc/scatter.cu` on the card and the plain `scatter_add_`
form on the CPU; its backward is a gather. The kernel adds each cell's
points one after another in point order, from 0, then divides by the
count. These tests hold, on the CPU:
- the plain version to that order bit for bit (a float32 loop in numpy),
  so the kernel's arithmetic is the plain version's (the card's tests hold
  the kernel to the plain version on a CPU copy);
- the port's `scatter_mean_2d` and its gradient to JAX's one-hot matmul at
  `Precision.HIGH`: atol 1e-6 of the features' largest magnitude (sums of
  a few terms in another order);
- the Function's backward, through its CPU branch, to autograd of the
  plain form, bit for bit.
Shapes: a 64x64 plane and the grid's 32^3 cells, with cells shared by
many points (clustered indices) and empty cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.ops import scatter as jscatter
from if_defense_tpu_torch.ops import cuda_scatter
from if_defense_tpu_torch.ops import scatter as tscatter

CELLS = {"plane 64^2": 64 * 64, "grid 32^3": 32**3}
B, N, C = 2, 300, 8
TOL = 1e-6          # of the features' largest magnitude


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cells: int, seed: int):
    """Features of mixed scale and cell indices in which a few cells hold
    many points (a cluster), most hold one, and most cells are empty."""
    rng = np.random.default_rng(seed)
    feat = (rng.normal(size=(B, N, C))
            * rng.uniform(0.01, 10.0, (B, N, 1))).astype(np.float32)
    idx = rng.integers(0, cells, (B, N))
    hot = rng.integers(0, cells, 4)
    idx[:, : N // 2] = hot[rng.integers(0, 4, (B, N // 2))]
    rng.permuted(idx, axis=1, out=idx)
    return feat, idx.astype(np.int32)


def _in_point_order(feat: np.ndarray, idx: np.ndarray, cells: int):
    """The kernel's arithmetic: each cell's points added in point order to
    a float32 0, then divided by the count."""
    sums = np.zeros((B, cells, C), np.float32)
    counts = np.zeros((B, cells), np.int64)
    for b in range(B):
        for n in range(N):
            sums[b, idx[b, n]] = np.float32(sums[b, idx[b, n]]
                                            + feat[b, n])
            counts[b, idx[b, n]] += 1
    return sums / np.maximum(counts, 1).astype(np.float32)[..., None]


@pytest.mark.parametrize("cells", list(CELLS.values()), ids=list(CELLS))
def test_plain_sums_in_point_order(cells):
    feat, idx = _inputs(cells, 0)
    want = _in_point_order(feat, idx, cells)
    got, counts = tscatter.scatter_mean_2d_plain(
        torch.from_numpy(feat), torch.from_numpy(idx), cells)
    assert np.array_equal(got.numpy(), want)
    occupied = (counts > 0).sum(1)
    assert int(occupied.max()) < cells // 8       # most cells empty
    assert int(counts.max()) >= N // 8           # shared by many points


@pytest.mark.parametrize("cells", list(CELLS.values()), ids=list(CELLS))
def test_scatter_mean_and_gradient_match_jax(cells):
    feat, idx = _inputs(cells, 1)
    w = np.random.default_rng(2).normal(size=(B, cells, C)).astype(np.float32)

    def jloss(f):
        return jnp.sum(jscatter.scatter_mean_2d(f, jnp.asarray(idx), cells)
                       * w)

    jout = np.asarray(jscatter.scatter_mean_2d(
        jnp.asarray(feat), jnp.asarray(idx), cells))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(feat)))
    launched = cuda_scatter.launches["scatter_mean"]
    f = torch.from_numpy(feat).requires_grad_(True)
    out = tscatter.scatter_mean_2d(f, torch.from_numpy(idx), cells)
    (out * torch.from_numpy(w)).sum().backward()
    assert cuda_scatter.launches["scatter_mean"] == launched  # plain on CPU
    scale = float(np.abs(feat).max())
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0,
                               atol=TOL * scale)
    np.testing.assert_allclose(f.grad.numpy(), jgrad, rtol=0,
                               atol=TOL * float(np.abs(jgrad).max()))
    for b in range(B):
        empty = ~np.isin(np.arange(cells), idx[b])
        assert not out[b, torch.from_numpy(empty)].any()


@pytest.mark.parametrize("cells", list(CELLS.values()), ids=list(CELLS))
def test_backward_cpu_branch_equals_plain_autograd(cells):
    feat, idx = _inputs(cells, 3)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, cells, C)).astype(np.float32))
    index = torch.from_numpy(idx)
    f = torch.from_numpy(feat).requires_grad_(True)
    out = tscatter.scatter_mean_2d(f, index, cells)
    out.backward(g)
    fp = torch.from_numpy(feat).requires_grad_(True)
    plain, _ = tscatter.scatter_mean_2d_plain(fp, index, cells)
    plain.backward(g)
    assert torch.equal(out, plain)
    assert torch.equal(f.grad, fp.grad)
    assert out.grad_fn.name().endswith("_ScatterMeanBackward")


def test_kernel_wrapper_takes_cuda_tensors_only():
    feat, idx = _inputs(64, 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_scatter.scatter_mean_cuda(torch.from_numpy(feat),
                                       torch.from_numpy(idx), 64)
