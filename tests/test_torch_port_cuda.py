"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test carries the `cuda` marker and skips where no CUDA device is
present (decided at run time by the `cuda` fixture). This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances: losses rtol 1e-5 (atol 1e-9); gradients rtol 1e-4 in f32 and
2^-7 (one bf16 rounding) in bf16, with atol 1e-5 of the largest entry
(pair terms summed in other orders); the B2 mask bit-equal; B4 output atol
1e-5 and uv gradient rtol 1e-5 in f32; B5 (FPS) and B6 (ball query)
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
    plane = torch.zeros(1, 8, 8, 4, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="plane gradient"):
        plane_sample_cuda(plane, torch.zeros(1, 3, 2, device=cuda))
    with pytest.raises(ValueError, match="16384"):
        fps_cuda(torch.zeros(1, 16385, 3, device=cuda), 8)
    with pytest.raises(ValueError, match="12288"):
        ballquery_cuda(0.1, 8, torch.zeros(1, 12289, 3, device=cuda),
                       torch.zeros(1, 4, 3, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        fps_cuda(torch.zeros(1, 16, 3, device=cuda, dtype=torch.float64), 8)
