"""The gather and its backward in a fixed order, PyTorch port vs JAX
package, on the CPU; victim training under deterministic algorithms that
rests on it.

`ops.pointops.index_points` (and `gather_neighbors`, which is it) is a
`torch.gather` forward. On CUDA points that need a gradient its backward is
the kernel `csrc/gather.cu` (`ops/cuda_gather.py`), which adds each point's
rows one after another in row order from 0; on CPU tensors it is the plain
version, `index_points_plain`, whose autograd adds in that order too. These
tests hold, on the CPU:
- the plain version's gradient to that order bit for bit (float32 loops in
  numpy), so the kernel's arithmetic is the plain version's (the card's
  tests hold the kernel to the plain version on a CPU copy);
- the port's `index_points` and `gather_neighbors` to the JAX package's
  under `jax.vjp`: the values bit-equal (a gather copies), the gradients
  within rtol 1e-6 of `index_points`'s (an XLA scatter-add: the same sums,
  in an order XLA picks) and 1e-5 of `gather_neighbors`'s (a one-hot
  contraction in bf16x3, accurate to ~1e-7 relative a term). A sum's
  rounding scales with its terms' magnitudes, not with the sum, so rtol is
  taken of each entry's sum of |terms| (a cancelling sum of terms ~10 that
  lands near 0.07 is 4.6e-5 off JAX's in its own terms);
- `index_points` on CPU tensors being the plain version, value and
  gradient, with no launch; the autograd Function the card takes (its
  backward, and the backward of that, on the kernel's plain arithmetic
  here) through `gradcheck` and `gradgradcheck` in float64;
- the kernel's wrapper refusing what it does not take;
- `cli/train.py` running its steps under deterministic algorithms and
  restoring the caller's flags and `CUBLAS_WORKSPACE_CONFIG`, and two
  seeded CPU runs of the train CLI writing the same bytes;
- `utils.determinism.setting`, which the profiling tools time a train step
  in, setting each of its three settings and restoring the caller's.
Inputs: indices drawn from a small range (many rows read one point, most
points none), shaped as the victims' gathers (DGCNN's kNN groups,
PointNet++'s ball-query groups, a flat row list), int32 and int64.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.ops import pointops as jpointops
from if_defense_tpu_torch.cli import train
from if_defense_tpu_torch.data import save_npz
from if_defense_tpu_torch.ops import cuda_gather
from if_defense_tpu_torch.ops import pointops as tpointops
from if_defense_tpu_torch.utils.determinism import (
    CUBLAS_WORKSPACE,
    SETTINGS,
    setting,
)

B, N, C = 2, 96, 6
# idx shapes [B, ...]: DGCNN's kNN groups, PointNet++'s ball-query groups,
# a flat row list; each point read by rows drawn from `hot` of the N points
CASES = {"knn groups": ((B, 48, 20), 12), "ball groups": ((B, 16, 32), 24),
         "rows": ((B, 300), 8)}
RTOL = {"index_points": 1e-6, "gather_neighbors": 1e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, hot: int, dtype, seed: int):
    """Points of mixed scale, indices into `hot` of the N points (so many
    rows share a point and most points are read by none), and a gradient
    of the gather's output."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(B, N, C))
           * rng.uniform(0.01, 10.0, (B, N, 1))).astype(np.float32)
    chosen = np.stack([rng.choice(N, hot, replace=False) for _ in range(B)])
    pick = rng.integers(0, hot, shape)
    idx = np.take_along_axis(chosen, pick.reshape(B, -1), 1).reshape(shape)
    g = rng.normal(size=(*shape, C)).astype(np.float32)
    return pts, idx.astype(dtype), g


def _in_row_order(idx: np.ndarray, g: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic: each point's rows added in row order to a
    float32 0."""
    flat, gf = idx.reshape(B, -1), g.reshape(B, -1, C)
    grad = np.zeros((B, N, C), np.float32)
    for b in range(B):
        for m in range(flat.shape[1]):
            grad[b, flat[b, m]] = np.float32(grad[b, flat[b, m]] + gf[b, m])
    return grad


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().numpy().tobytes()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_gradient_in_row_order(case, dtype):
    shape, hot = CASES[case]
    pts, idx, g = _inputs(shape, hot, dtype, 0)
    x = torch.from_numpy(pts).requires_grad_(True)
    out = tpointops.index_points_plain(x, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    assert _bits(out) == np.take_along_axis(
        pts[:, :, None], idx.reshape(B, -1, 1, 1).astype(np.int64), 1
    ).reshape(*shape, C).tobytes()
    want = _in_row_order(idx, g)
    assert _bits(x.grad) == want.tobytes()
    reads = np.stack([np.bincount(idx[b].ravel(), minlength=N)
                      for b in range(B)])
    assert reads.max() >= 8                 # many rows read one point
    assert (reads == 0).sum() > B * N // 2  # most points read by none


@pytest.mark.parametrize("name", list(RTOL))
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", list(CASES))
def test_gather_and_gradient_match_jax(case, dtype, name):
    shape, hot = CASES[case]
    pts, idx, g = _inputs(shape, hot, dtype, 1)
    jout, vjp = jax.vjp(
        lambda p: getattr(jpointops, name)(p, jnp.asarray(idx)),
        jnp.asarray(pts))
    (jgrad,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(pts).requires_grad_(True)
    out = getattr(tpointops, name)(x, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    assert _bits(out) == np.asarray(jout).tobytes()
    scale = _in_row_order(idx, np.abs(g))           # each sum's |terms|
    err = np.abs(x.grad.numpy() - np.asarray(jgrad))
    assert (err <= RTOL[name] * scale).all(), float((err / np.maximum(
        scale, 1e-30)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_index_points_runs_the_plain_version_on_the_cpu(case):
    shape, hot = CASES[case]
    pts, idx, g = _inputs(shape, hot, np.int64, 2)
    index = torch.from_numpy(idx)
    launched = dict(cuda_gather.launches)
    got, want = [], []
    for fn, grads in ((tpointops.index_points, got),
                      (tpointops.index_points_plain, want)):
        x = torch.from_numpy(pts).requires_grad_(True)
        out = fn(x, index)
        out.backward(torch.from_numpy(g))
        grads += [_bits(out), _bits(x.grad), out.grad_fn.name()]
    assert cuda_gather.launches == launched
    assert got == want
    assert not got[2].startswith("_IndexPoints")


def _plain_kernel(grad_out, flat, num_points):
    """The kernel's arithmetic in plain PyTorch (the CPU's `scatter_add_`
    in row order), standing in for it on CPU tensors."""
    return grad_out.new_zeros(grad_out.shape[0], num_points,
                              grad_out.shape[2]).scatter_add_(
        1, flat.long()[..., None].expand(-1, -1, grad_out.shape[2]), grad_out)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_the_cards_function_has_the_gathers_derivatives(dtype, monkeypatch):
    """`index_points`' Function on the card, with the kernel's plain
    arithmetic in its place: first and second derivatives of the gather
    (`gradcheck`, `gradgradcheck` in float64), and its gradient the plain
    version's bits in float32."""
    monkeypatch.setattr(tpointops, "_gather_backward", _plain_kernel)
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.integers(0, 5, (2, 30))).to(dtype)
    x = torch.from_numpy(rng.normal(size=(2, 9, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda p: tpointops._IndexPoints.apply(p, flat), (x,))
    assert torch.autograd.gradgradcheck(
        lambda p: tpointops._IndexPoints.apply(p, flat), (x,))
    pts, idx, g = _inputs((B, 300), 8, np.int64, 4)
    xf = torch.from_numpy(pts).requires_grad_(True)
    tpointops._IndexPoints.apply(xf, torch.from_numpy(idx)).backward(
        torch.from_numpy(g))
    assert _bits(xf.grad) == _in_row_order(idx, g).tobytes()


def test_gather_backward_wrapper_refuses():
    g = torch.zeros(2, 5, 3)
    i = torch.zeros(2, 5, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_gather.gather_backward_cuda(g, i, 4)
    with pytest.raises(TypeError, match="float32"):
        cuda_gather.gather_backward_cuda(g.double(), i, 4)
    with pytest.raises(TypeError, match="float32"):
        cuda_gather.gather_backward_cuda(g.bfloat16(), i, 4)
    with pytest.raises(ValueError, match=r"\[B, M, C\]"):
        cuda_gather.gather_backward_cuda(g[0], i, 4)
    with pytest.raises(ValueError, match="idx must be"):
        cuda_gather.gather_backward_cuda(g, i[:, :3], 4)
    with pytest.raises(TypeError, match="int32 or int64"):
        cuda_gather.gather_backward_cuda(g, i.to(torch.int16), 4)
    with pytest.raises(ValueError, match="num_points"):
        cuda_gather.gather_backward_cuda(g, i, 0)


def _write_data(path, seed: int):
    """8 train and 4 test clouds of 80 points on ellipsoids, 4 classes."""
    rng = np.random.default_rng(seed)

    def clouds(n):
        d = rng.normal(size=(n, 80, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (d * rng.uniform(0.1, 1, (n, 1, 3))).astype(np.float32)

    return save_npz(str(path), {
        "train_pc": clouds(8), "train_label": rng.integers(0, 4, 8),
        "test_pc": clouds(4), "test_label": rng.integers(0, 4, 4)})


@pytest.mark.parametrize("name", SETTINGS)
def test_determinism_setting_sets_and_restores(name):
    """`setting(name)`: deterministic algorithms on but for `free`, the NaN
    fill of new tensors on but for `no fill`; the caller's flags, warn-only
    setting and fill setting are back after an exception."""
    det = torch.utils.deterministic
    flag = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory
    try:
        for before in (False, True):
            torch.use_deterministic_algorithms(before, warn_only=True)
            det.fill_uninitialized_memory = before
            with pytest.raises(RuntimeError, match="inside"):
                with setting(name):
                    assert torch.are_deterministic_algorithms_enabled() == (
                        name != "free")
                    assert det.fill_uninitialized_memory == (
                        name != "no fill")
                    raise RuntimeError("inside")
            assert torch.are_deterministic_algorithms_enabled() == before
            assert torch.is_deterministic_algorithms_warn_only_enabled()
            assert det.fill_uninitialized_memory == before
        with pytest.raises(ValueError, match="not one of"):
            with setting("off"):
                pass
    finally:
        torch.use_deterministic_algorithms(flag, warn_only=warn_only)
        det.fill_uninitialized_memory = fill


def _train_argv(data, out, *extra):
    return ["--data", data, "--output", str(out), "--num_points", "64",
            "--batch_size", "4", "--epochs", "1", "--seed", "5",
            "--registry", os.path.join(str(out), "reg.json"), "--device",
            "cpu", *extra]


@pytest.mark.parametrize("env", [None, ":16:8"], ids=["unset", "set"])
def test_train_cli_runs_under_deterministic_algorithms(env, tmp_path,
                                                       monkeypatch):
    """Every train step of `cli/train.py` runs with deterministic
    algorithms on (the cuBLAS workspace set where it was unset); on return
    the caller's flags and environment are back."""
    if env is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", env)
    make = train.make_train_step
    seen = []

    def spy(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(*a, **k):
            seen.append((torch.are_deterministic_algorithms_enabled(),
                         os.environ.get("CUBLAS_WORKSPACE_CONFIG")))
            return step(*a, **k)
        return run

    monkeypatch.setattr(train, "make_train_step", spy)
    flag = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        train.main(_train_argv(_write_data(tmp_path / "d.npz", 6),
                               tmp_path / "out", "--model", "pointnet"))
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(False)
        train.main(_train_argv(_write_data(tmp_path / "d.npz", 6),
                               tmp_path / "out2", "--model", "pointnet"))
        assert not torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(flag, warn_only=warn_only)
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == env
    assert seen == [(True, env or CUBLAS_WORKSPACE)] * 4   # 2 runs x 2 steps


@pytest.mark.parametrize("model", ["pointnet2", "dgcnn"])
def test_train_cli_repeats_from_its_seed(model, tmp_path):
    """Two `cli/train.py --device cpu` runs from one seed (1 epoch of 2
    steps, N = 64): the same bytes in every weight, batch statistic and
    Adam moment of `final.npz` and its optimiser sidecar, and the same
    records but for the clock."""
    data = _write_data(tmp_path / "d.npz", 7)
    runs = []
    for run in ("a", "b"):
        out = tmp_path / run
        train.main(_train_argv(data, out, "--model", model))
        arrays = {}
        for name in ("final.npz", "final.npz.opt.npz"):
            with np.load(out / name) as z:
                arrays.update({f"{name}/{k}": z[k] for k in z.files})
        with open(out / "metrics.jsonl") as f:
            records = [{k: v for k, v in json.loads(line).items()
                        if k not in ("time", "epoch_time")} for line in f]
        runs.append((arrays, records))
    (a, ra), (b, rb) = runs
    assert a.keys() == b.keys() and len(a) > 2
    for k, v in a.items():
        assert v.tobytes() == b[k].tobytes(), k
    assert ra == rb
