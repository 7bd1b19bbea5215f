"""The CSR that the port's fixed-order kernels read (`ops/cuda_csr.py`,
`csrc/csr.cu`), on the CPU: its plain version against numpy's stable
argsort and counts, the order it gives against the plain versions'
autograd, and the wrappers' refusals. The kernel itself runs on the card
only (`tests/test_torch_port_cuda.py`, `chip_smoke.py` phase 2).
"""

import numpy as np
import pytest
import torch

from if_defense_tpu_torch.ops import cuda_csr
from if_defense_tpu_torch.ops.pointops import index_points_plain
from if_defense_tpu_torch.ops.scatter import cell_csr


def _case(name: str) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(7)
    if name == "random":
        return rng.integers(0, 1024, (4, 20 * 64)), 1024
    if name == "ties":
        return rng.choice(rng.permutation(1024)[:8], (4, 3000)), 1024
    if name == "one target":
        return np.full((2, 2500), 5), 64
    if name == "mostly empty":
        return rng.integers(0, 32**3, (3, 600)), 32**3
    if name == "device tier":
        return rng.integers(0, 40000, (2, 3000)), 40000
    return np.zeros((2, 0), np.int64), 9


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("name", ["random", "ties", "one target",
                                  "mostly empty", "device tier", "no rows"])
def test_csr_plain_is_the_stable_argsort(name, dtype):
    idx, k = _case(name)
    csr = cuda_csr.csr_plain(torch.from_numpy(idx).to(dtype), k)
    assert csr.offsets.dtype == csr.rows.dtype == torch.int32
    assert csr.offsets.shape == (idx.shape[0], k + 1)
    assert np.array_equal(csr.rows.numpy(),
                          np.argsort(idx, axis=1, kind="stable"))
    counts = np.stack([np.bincount(r, minlength=k) for r in idx]) \
        if idx.size else np.zeros((idx.shape[0], k), np.int64)
    want = np.concatenate([np.zeros((idx.shape[0], 1), np.int64),
                           counts.cumsum(1)], 1)
    assert np.array_equal(csr.offsets.numpy(), want)
    assert csr.num_targets == k and csr.index.dtype == dtype


def test_csr_order_is_the_plain_gradients_order():
    """Adding each point's rows from 0.0 in the CSR's order (the gather
    kernel's order, written out in float32) gives every bit of the plain
    gather's autograd on the CPU, ties included."""
    idx, n = _case("ties")
    rng = np.random.default_rng(8)
    g = rng.normal(size=(*idx.shape, 5)).astype(np.float32)
    x = torch.zeros((idx.shape[0], n, 5), requires_grad=True)
    index_points_plain(x, torch.from_numpy(idx)).backward(torch.from_numpy(g))
    csr = cuda_csr.csr_plain(torch.from_numpy(idx), n)
    offs, rows = csr.offsets.numpy(), csr.rows.numpy()
    want = np.zeros((idx.shape[0], n, 5), np.float32)
    for b in range(idx.shape[0]):
        for p in range(n):
            s = np.zeros(5, np.float32)
            for j in range(offs[b, p], offs[b, p + 1]):
                s = s + g[b, rows[b, j]]
            want[b, p] = s
    assert want.tobytes() == x.grad.numpy().tobytes()


def test_csr_refuses():
    i = torch.zeros(2, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_csr.build_csr(i, 4)
    with pytest.raises(TypeError, match="integer"):
        cuda_csr.build_csr(i.float(), 4)
    with pytest.raises(ValueError, match=r"\[B, M\]"):
        cuda_csr.build_csr(i[0], 4)
    with pytest.raises(ValueError, match="out of range"):
        cuda_csr.build_csr(i, 0)
    i[1, 3] = 4
    with pytest.raises(IndexError, match="outside"):
        cuda_csr.csr_plain(i, 4)
    assert cell_csr(i, 5) is None          # the CPU's plain versions need none


@pytest.mark.parametrize("wrapper", ["scatter_mean_cuda", "pooled_max_cuda"])
def test_wrappers_refuse_a_csr_that_does_not_fit(wrapper):
    """A CSR handed to the encoder's kernels is the one source of the
    cells on the card, so one of another cell count or another index shape
    is refused before anything runs."""
    from if_defense_tpu_torch.ops import cuda_scatter

    fn = getattr(cuda_scatter, wrapper)
    f = torch.zeros(2, 8, 4)
    i = torch.zeros(2, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="does not fit"):
        fn(f, i, 16, csr=cuda_csr.csr_plain(i, 32))
    with pytest.raises(ValueError, match="does not fit"):
        fn(f, i, 16, csr=cuda_csr.csr_plain(i[:, :4], 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(f, i, 16, csr=cuda_csr.csr_plain(i.clone(), 16))
