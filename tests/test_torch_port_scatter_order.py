"""The encoder's scatter-mean and pooled max in a fixed order, PyTorch
port vs JAX package, on the CPU; the determinism context and seeded
occupancy training that rest on them.

`ops.scatter.scatter_mean_2d` is an autograd Function: its forward is the
CUDA kernel `csrc/scatter.cu` on the card and the plain `scatter_add_`
form on the CPU; its backward is a gather. The kernel adds each cell's
points one after another in point order, from 0, then divides by the
count. `ops.scatter.pooled_max_by_cell` runs kernels both ways on the card
(an autograd Function) and its plain version on the CPU: the forward gives each point its cell's max (the first of
equal values in point order), the backward adds each cell's output
gradients in point order from 0, divides by the cell's tie count and
gives the quotient to the points equal to the max. These tests hold, on
the CPU:
- the plain versions to that order bit for bit (float32 loops in numpy),
  so the kernels' arithmetic is the plain versions' (the card's tests
  hold the kernels to the plain versions on a CPU copy);
- the port's `scatter_mean_2d` and its gradient to JAX's one-hot matmul at
  `Precision.HIGH`: atol 1e-6 of the features' largest magnitude (sums of
  a few terms in another order); the pooled max and its gradient to JAX's
  masked max under `jax.grad` at rtol 1e-5 and atol 1e-6 of the largest
  magnitude, ties included (both share a tie's gradient evenly);
- the scatter-mean Function's CPU branch to autograd of the plain form,
  bit for bit, and `pooled_max_by_cell` on CPU tensors being its plain
  version, with no launch;
- `utils.determinism.deterministic` setting and restoring its flags and
  `CUBLAS_WORKSPACE_CONFIG`, and `cli/train_implicit.py` writing the same
  bits twice from one seed, for both variants.
Shapes: a 64x64 plane and the grid's 32^3 cells, with cells shared by
many points (clustered indices) and empty cells; the pooled max's
clouds repeat every third point (features and cell), so maxima tie.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.ops import scatter as jscatter
from if_defense_tpu_torch.cli import train_implicit
from if_defense_tpu_torch.ops import cuda_scatter
from if_defense_tpu_torch.ops import scatter as tscatter
from if_defense_tpu_torch.utils.determinism import (
    CUBLAS_WORKSPACE,
    deterministic,
)

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


def _tied(cells: int, seed: int):
    """`_inputs` with every third point a copy of the point before it,
    features and cell (a cloud sampled with replacement): maxima tie."""
    feat, idx = _inputs(cells, seed)
    feat[:, 1::3] = feat[:, 0::3][:, :N // 3]
    idx[:, 1::3] = idx[:, 0::3][:, :N // 3]
    return feat, idx


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().numpy().tobytes()


def _pooled_max_in_point_order(feat, idx, g):
    """The kernels' arithmetic in float32: each cell's points in point
    order, the max keeping the first of equal values; the tie count (the
    points equal to the max); the output gradients added from 0, divided
    by the count, given to the points equal to the max times 1, to the
    others times 0. -> (out, grad, the largest tie count)."""
    out = np.empty_like(feat)
    grad = np.empty_like(feat)
    most = 0
    for b in range(B):
        for cell in np.unique(idx[b]):
            pts = np.flatnonzero(idx[b] == cell)          # point order
            for c in range(C):
                m = np.float32(-np.inf)
                for n in pts:
                    m = feat[b, n, c] if m < feat[b, n, c] else m
                ties = np.float32(0)
                s = np.float32(0)
                for n in pts:
                    ties = np.float32(ties + (feat[b, n, c] == m))
                    s = np.float32(s + g[b, n, c])
                q = np.float32(s / ties)
                most = max(most, int(ties))
                for n in pts:
                    out[b, n, c] = m
                    grad[b, n, c] = np.float32(
                        np.float32(feat[b, n, c] == m) * q)
    return out, grad, most


@pytest.mark.parametrize("cells", list(CELLS.values()), ids=list(CELLS))
def test_pooled_max_plain_in_point_order(cells):
    feat, idx = _tied(cells, 6)
    g = np.random.default_rng(7).normal(size=feat.shape).astype(np.float32)
    want_out, want_grad, most = _pooled_max_in_point_order(feat, idx, g)
    f = torch.from_numpy(feat).requires_grad_(True)
    out = tscatter.pooled_max_by_cell_plain(f, torch.from_numpy(idx), cells)
    out.backward(torch.from_numpy(g))
    assert _bits(out) == want_out.tobytes()
    assert _bits(f.grad) == want_grad.tobytes()
    assert most >= 2                                  # maxima tie


@pytest.mark.parametrize("cells", list(CELLS.values()), ids=list(CELLS))
def test_pooled_max_runs_the_plain_version_on_the_cpu(cells):
    """On CPU tensors `pooled_max_by_cell` is the plain version, value and
    gradient, with ties and empty cells; no kernel is launched."""
    feat, idx = _tied(cells, 8)
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=feat.shape).astype(np.float32))
    index = torch.from_numpy(idx)
    launched = dict(cuda_scatter.launches)
    f = torch.from_numpy(feat).requires_grad_(True)
    out = tscatter.pooled_max_by_cell(f, index, cells)
    out.backward(g)
    fp = torch.from_numpy(feat).requires_grad_(True)
    plain = tscatter.pooled_max_by_cell_plain(fp, index, cells)
    plain.backward(g)
    assert cuda_scatter.launches == launched
    assert _bits(out) == _bits(plain)
    assert _bits(f.grad) == _bits(fp.grad)
    ties = torch.zeros(B, cells, C).scatter_add_(
        1, index.long()[..., None].expand(-1, -1, C), (f == out).float())
    assert int(ties.max()) >= 2                       # maxima tie
    occupied = torch.zeros(B, cells).scatter_add_(
        1, index.long(), torch.ones(B, N))
    assert int((occupied == 0).sum()) > 0             # empty cells


@pytest.mark.parametrize("cells", list(CELLS.values()), ids=list(CELLS))
def test_pooled_max_and_gradient_match_jax(cells):
    feat, idx = _tied(cells, 10)
    w = np.random.default_rng(11).normal(size=feat.shape).astype(np.float32)

    def jloss(x):
        return jnp.sum(jscatter.pooled_max_by_cell(x, jnp.asarray(idx)) * w)

    jout = np.asarray(jscatter.pooled_max_by_cell(jnp.asarray(feat),
                                                  jnp.asarray(idx)))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(feat)))
    f = torch.from_numpy(feat).requires_grad_(True)
    out = tscatter.pooled_max_by_cell(f, torch.from_numpy(idx), cells)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=TOL * float(np.abs(jout).max()))
    np.testing.assert_allclose(f.grad.numpy(), jgrad, rtol=1e-5,
                               atol=TOL * float(np.abs(jgrad).max()))
    # a tie's gradient shared: some point's gradient is a share of its
    # cell's, not all of it and not 0
    assert np.any((f.grad.numpy() != 0) & (np.abs(f.grad.numpy())
                                          < np.abs(jgrad).max()))


def test_pooled_max_wrapper_refuses():
    feat, idx = _inputs(64, 12)
    f, i = torch.from_numpy(feat), torch.from_numpy(idx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_scatter.pooled_max_cuda(f, i, 64)
    with pytest.raises(TypeError, match="float32"):
        cuda_scatter.pooled_max_cuda(f.double(), i, 64)
    with pytest.raises(ValueError, match=r"\[B, N, C\]"):
        cuda_scatter.pooled_max_cuda(f[0], i, 64)
    with pytest.raises(ValueError, match="index must be"):
        cuda_scatter.pooled_max_cuda(f, i[:, :4], 64)
    with pytest.raises(TypeError, match="index must be integer"):
        cuda_scatter.pooled_max_cuda(f, i.float(), 64)
    with pytest.raises(ValueError, match="num_cells"):
        cuda_scatter.pooled_max_cuda(f, i, 0)


@pytest.mark.parametrize("env", [None, ":16:8"], ids=["unset", "set"])
def test_deterministic_sets_and_restores(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", env)
    flag = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    benchmark = torch.backends.cudnn.benchmark
    try:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = True
        with pytest.raises(RuntimeError, match="inside"):
            with deterministic():
                assert torch.are_deterministic_algorithms_enabled()
                assert not torch.is_deterministic_algorithms_warn_only_enabled()
                assert not torch.backends.cudnn.benchmark
                assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == (
                    env or CUBLAS_WORKSPACE)
                raise RuntimeError("inside")
        assert not torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.benchmark
        assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == env
        torch.use_deterministic_algorithms(True, warn_only=True)
        with deterministic():
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(flag, warn_only=warn_only)
        torch.backends.cudnn.benchmark = benchmark


@pytest.mark.parametrize("variant", ["convonet", "onet"])
def test_train_implicit_repeats_from_its_seed(variant, tmp_path):
    """Two `train_implicit --device cpu` runs from one seed at full width,
    2 steps: the same bytes in every weight."""
    rng = np.random.default_rng(13)
    data = str(tmp_path / "occ.npz")
    np.savez(data, pointcloud=rng.uniform(-0.4, 0.4, (4, 700, 3)).astype(
                 np.float32),
             points=rng.uniform(-0.55, 0.55, (4, 512, 3)).astype(np.float32),
             points_occ=(rng.uniform(size=(4, 512)) < 0.3).astype(
                 np.float32))
    weights = []
    for run in ("a", "b"):
        out = train_implicit.main([
            "--variant", variant, "--data", data, "--device", "cpu",
            "--batch_size", "2", "--steps", "2", "--points_subsample", "128",
            "--lr", "1e-3", "--seed", "3", "--output", str(tmp_path / run)])
        with np.load(out) as z:
            weights.append({k: z[k] for k in z.files})
    assert weights[0].keys() == weights[1].keys()
    for k, v in weights[0].items():
        assert v.tobytes() == weights[1][k].tobytes(), k
