"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test carries the `cuda` marker and skips where no CUDA device is
present (decided at run time by the `cuda` fixture). This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances: losses rtol 1e-5 (atol 1e-9); gradients rtol 1e-4 in f32 and
2^-7 (one bf16 rounding) in bf16, with atol 1e-5 of the largest entry
(pair terms summed in other orders); the B2 mask bit-equal; B1 and B3 also
bit-identical from one launch to the next; B4 output atol
1e-5 and uv gradient rtol 1e-5 in f32, its plane gradient atol 1e-5 of the
largest entry (f32 atomics add in no fixed order) and rtol 2^-7 for bf16
planes; B5 (FPS) and B6 (ball query)
indices bit-equal at PU-Net's four set-abstraction shapes, masked and not.
"""

import numpy as np
import pytest
import torch

from if_defense_tpu_torch.defense.repulsion import (
    repulsion_loss_masked,
    repulsion_loss_threshold,
    repulsion_mask,
)
from if_defense_tpu_torch.ops.interp import bilinear_plane_sample
from if_defense_tpu_torch.ops.pointops import (
    farthest_point_sample_plain,
    query_ball_point_plain,
)

pytestmark = pytest.mark.cuda

# PU-Net's set-abstraction levels: (input points, centres, radius)
SA_LEVELS = ((1024, 1024, 0.05), (1024, 512, 0.1), (512, 256, 0.2),
             (256, 128, 0.3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _points(seed, n=256):
    pc = np.random.default_rng(seed).uniform(-0.4, 0.4, (2, n, 3))
    pc = pc.astype(np.float32)
    pc[:, n // 2:] = pc[:, : n // 2]          # resampling repeats points
    return pc


def _lattice(n, seed):
    """2 clouds of the first n nodes of a 16 x 16 x 16 grid at spacing 1/16
    (every d2 exact, so rows tie at their k-th smallest), each in its own
    random order."""
    rng = np.random.default_rng(seed)
    axes = np.arange(16) - 8
    grid = np.stack(np.meshgrid(axes, axes, axes, indexing="ij"),
                    -1).reshape(-1, 3)[:n] / 16
    return np.stack([grid[rng.permutation(n)] for _ in range(2)]).astype(
        np.float32)


def _value_grad(fn, x, w):
    x = x.detach().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out * w).sum(), x)
    return out.detach().cpu(), g.cpu()


def _grad_close(got, want, rtol):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_repulsion_kernels_match_plain(cuda, dtype):
    from if_defense_tpu_torch.ops import cuda_repulsion as cr

    pc = torch.from_numpy(_points(6)).to(cuda, dtype)
    w = torch.tensor([1.0, 2.0], device=cuda)
    rtol = 1e-4 if dtype == torch.float32 else 2.0**-7
    lk, gk = _value_grad(cr.repulsion_loss_cuda, pc, w)
    lp, gp = _value_grad(repulsion_loss_threshold, pc, w)
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-9)
    _grad_close(gk, gp, rtol)
    mask = cr.repulsion_mask_cuda(pc)
    assert torch.equal(mask, repulsion_mask(pc))
    lk, gk = _value_grad(
        lambda x: cr.repulsion_loss_masked_cuda(x, mask), pc, w)
    lp, gp = _value_grad(lambda x: repulsion_loss_masked(x, mask), pc, w)
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-9)
    _grad_close(gk, gp, rtol)


@pytest.mark.parametrize("n", [300, 1000, 1024, 4096])
@pytest.mark.parametrize("cloud", ["lattice", "duplicates", "cluster"])
def test_cuda_repulsion_kernels_on_ties(cuda, cloud, n):
    """B1, B2 and B3 against their plain versions where rows tie at their
    threshold, for k in {1, 5, 8}, f32 and bf16; N not a multiple of 32 or
    of B3's 16-byte words (300, 1000), and 4096 = MAX_N, where B1's forward
    computes its distances twice and B3's backward stages j in chunks. In
    "cluster" 100 points coincide: their rows tie 99 ways at 0, more than a
    warp's list of weighted pairs holds. Two launches on one input give
    bit-identical losses and gradients."""
    from if_defense_tpu_torch.ops import cuda_repulsion as cr

    if cloud == "lattice":
        pts = _lattice(n, n)
    else:
        pts = _points(n, n)
        if cloud == "cluster":
            pts[:, 100:200] = pts[:, :1]
    pts = torch.from_numpy(pts).to(cuda)
    w = torch.tensor([1.0, 2.0], device=cuda)
    for k in (1, 5, 8):
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0**-7)):
            pc = pts.to(dtype)
            mask = cr.repulsion_mask_cuda(pc, k)
            assert torch.equal(mask, repulsion_mask(pc, k))
            pairs = (
                (lambda x: cr.repulsion_loss_cuda(x, k),
                 lambda x: repulsion_loss_threshold(x, k)),
                (lambda x: cr.repulsion_loss_masked_cuda(x, mask, k),
                 lambda x: repulsion_loss_masked(x, mask, k)))
            for kern, plain in pairs:
                lk, gk = _value_grad(kern, pc, w)
                lk2, gk2 = _value_grad(kern, pc, w)
                assert torch.equal(lk, lk2) and torch.equal(gk, gk2)
                lp, gp = _value_grad(plain, pc, w)
                torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-9)
                _grad_close(gk, gp, rtol)


def test_cuda_plane_sample_matches_plain(cuda):
    from if_defense_tpu_torch.ops.cuda_interp import plane_sample_cuda

    rng = np.random.default_rng(7)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    plane = dev(rng.normal(size=(2, 64, 64, 32)))
    uv = dev(rng.uniform(0, 1, (2, 1024, 2)))
    g = dev(rng.normal(size=(2, 1024, 32)))
    outs = []
    for fn in (plane_sample_cuda, bilinear_plane_sample):
        u = uv.clone().requires_grad_(True)
        out = fn(plane, u)
        (du,) = torch.autograd.grad((out * g).sum(), u)
        outs.append((out.detach(), du))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-5)
    _grad_close(outs[0][1], outs[1][1], 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_plane_gradient_matches_plain(cuda, dtype):
    """The plane gradient alone (training) and with the uv gradient, uv
    from [-0.1, 1.1] so that clamped queries add to the border cells."""
    from if_defense_tpu_torch.ops.cuda_interp import launches, plane_sample_cuda

    rng = np.random.default_rng(8)
    plane = torch.from_numpy(rng.normal(size=(2, 64, 64, 32)).astype(
        np.float32)).to(cuda, dtype)
    uv = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, 1024, 2)).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(2, 1024, 32)).astype(
        np.float32)).to(cuda)

    def plain(pl, u):        # the kernel's semantics: f32 math, plane's type out
        return bilinear_plane_sample(pl.float(), u).to(pl.dtype)

    rtol = 0.0 if dtype == torch.float32 else 2.0**-7
    for with_uv in (False, True):
        grads = []
        for fn in (plane_sample_cuda, plain):
            pl = plane.clone().requires_grad_(True)
            u = uv.clone().requires_grad_(with_uv)
            before = dict(launches)
            out = fn(pl, u)
            wrt = (pl, u) if with_uv else (pl,)
            grads.append(torch.autograd.grad((out.float() * g).sum(), wrt))
            if fn is plane_sample_cuda:     # forward, plus uv grad if asked
                assert launches["plane_sample"] - before["plane_sample"] \
                    == 1 + with_uv
                assert launches["plane_sample_dplane"] \
                    - before["plane_sample_dplane"] == 1
        (dk, *duk), (dp, *dup) = grads
        assert dk.dtype == dtype
        _grad_close(dk.cpu(), dp.cpu(), rtol)
        assert float(dp[:, 0, 0].abs().sum()) > 0       # border cells hit
        if with_uv:
            _grad_close(duk[0].cpu(), dup[0].cpu(), 1e-5)


def _sa_inputs(cuda, seed, n, masked):
    """4 clouds of n points; cloud 0 is duplicated (FPS to n points ends in
    0s); under a mask ~80 % valid and cloud 3 all invalid."""
    rng = np.random.default_rng(seed)
    pc = (rng.normal(size=(4, n, 3)) * 0.3).astype(np.float32)
    pc[0, n // 2:] = pc[0, : n // 2]
    mask = None
    if masked:
        mask = torch.from_numpy(rng.uniform(size=(4, n)) > 0.2).to(cuda)
        mask[3] = False
    return torch.from_numpy(pc).to(cuda), mask


@pytest.mark.parametrize("masked", [False, True])
def test_cuda_fps_matches_plain(cuda, masked):
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda

    for level, (n, npoint, _) in enumerate(SA_LEVELS):
        x, mask = _sa_inputs(cuda, level, n, masked)
        got = fps_cuda(x, npoint, mask=mask)
        assert got.dtype == torch.int32
        assert torch.equal(got, farthest_point_sample_plain(x, npoint,
                                                            mask=mask))
    start = torch.tensor([5, 0, 255, 100], device=cuda)
    assert torch.equal(fps_cuda(x, 64, start), farthest_point_sample_plain(
        x, 64, start))


@pytest.mark.parametrize("masked", [False, True])
def test_cuda_ballquery_matches_plain(cuda, masked):
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda

    for level, (n, s, radius) in enumerate(SA_LEVELS):
        x, mask = _sa_inputs(cuda, 10 + level, n, masked)
        q = x[:, :s].contiguous()
        q[:, :4] += 5.0                                    # no hit
        got = ballquery_cuda(radius, 32, x, q, mask)
        assert got.dtype == torch.int32
        assert torch.equal(got, query_ball_point_plain(radius, 32, x, q,
                                                       mask))


def test_cuda_wrappers_refuse(cuda):
    from if_defense_tpu_torch.ops.cuda_ballquery import ballquery_cuda
    from if_defense_tpu_torch.ops.cuda_fps import fps_cuda
    from if_defense_tpu_torch.ops.cuda_interp import plane_sample_cuda
    from if_defense_tpu_torch.ops.cuda_repulsion import repulsion_loss_cuda

    with pytest.raises(ValueError, match="4096"):
        repulsion_loss_cuda(torch.zeros(1, 4097, 3, device=cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        plane_sample_cuda(torch.zeros(1, 8, 8, 4, device=cuda,
                                      dtype=torch.float64),
                          torch.zeros(1, 3, 2, device=cuda))
    with pytest.raises(ValueError, match="16384"):
        fps_cuda(torch.zeros(1, 16385, 3, device=cuda), 8)
    with pytest.raises(ValueError, match="12288"):
        ballquery_cuda(0.1, 8, torch.zeros(1, 12289, 3, device=cuda),
                       torch.zeros(1, 4, 3, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        fps_cuda(torch.zeros(1, 16, 3, device=cuda, dtype=torch.float64), 8)
